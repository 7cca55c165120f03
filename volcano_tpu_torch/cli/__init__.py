"""CLI (reference cmd/cli vcctl + pkg/cli)."""

from .vcctl import ALIASES, build_parser, main  # noqa: F401
