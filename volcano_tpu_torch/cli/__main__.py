import sys

from .vcctl import main

if __name__ == "__main__":
    print(main(sys.argv[1:]))
