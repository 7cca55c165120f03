#!/bin/sh
# Render the parameterized manifests (the build's helm-install analog):
#   ./render.sh                 -> all templates, one stream, defaults
#   ./render.sh my-values.env   -> defaults overlaid with your values
#   ./render.sh -o DIR [values] -> one rendered file per template in DIR
# Pipe the stream form to kubectl apply -f -.
# (envsubst-free: the image may not ship gettext, python3 always exists.)
set -e
dir="$(dirname "$0")"
outdir=""
if [ "$1" = "-o" ]; then
    outdir="$2"
    shift 2
fi
set -a
. "$dir/values.env"
for f in "$@"; do
    # dash's `.` PATH-searches bare filenames; anchor relative paths
    case "$f" in
        */*) . "$f" ;;
        *) . "./$f" ;;
    esac
done
set +a
VT_OUTDIR="$outdir" python3 - "$dir"/templates/*.yaml.tmpl <<'PY'
import os
import re
import sys

outdir = os.environ.get("VT_OUTDIR") or None


def render(path):
    text = open(path).read()
    out = re.sub(r"\$\{(\w+)\}",
                 lambda m: os.environ.get(m.group(1), m.group(0)), text)
    missing = sorted(set(re.findall(r"\$\{(\w+)\}", out)))
    if missing:
        sys.stderr.write(f"{path}: unset template variables: {missing}\n")
        raise SystemExit(1)
    return out


BANNER = ("# GENERATED by installer_torch/helm/render.sh from "
          "installer_torch/helm/templates/ + values.env.\n"
          "# Edit the template and re-render; tests assert the committed "
          "copies stay in sync.\n")

for i, path in enumerate(sys.argv[1:]):
    out = BANNER + render(path)
    if outdir:
        name = os.path.basename(path)[: -len(".tmpl")]
        with open(os.path.join(outdir, name), "w") as f:
            f.write(out)
    else:
        if i:
            sys.stdout.write("---\n")
        sys.stdout.write(out)
PY
