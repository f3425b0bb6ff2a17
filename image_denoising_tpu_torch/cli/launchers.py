"""Read a launcher preset (``scripts/*.sh``, ``scripts/*.ps1`` and their
CUDA twins under ``scripts/cuda/``) into the argument lists it passes.

A launcher sets variables (``NAME=value`` in bash, ``$NAME = value`` in
PowerShell) and calls ``python3 -m <module> --flag value ...`` with
backslash or backtick continuations. ``read_launcher`` expands the
variables and returns each call's module and argv, so a test can hold a
launcher's flags to a parser and a script can run the preset in-process
through the CLI's ``main(argv)``.
"""
from __future__ import annotations

import re
import shlex
from typing import Dict, List, Optional, Tuple

__all__ = ["flag_values", "read_launcher"]

_ASSIGN = re.compile(r"^\$?([A-Za-z_]\w*)\s*=\s*(.*)$")
_CALL = re.compile(r"^python3?\s+-m\s+([\w.]+)(.*)$")
_VAR = re.compile(r"\$\{(\w+)\}|\$(\w+)")


def read_launcher(path: str) -> List[Tuple[str, List[str]]]:
    """[(module, argv)] of each ``python -m`` call in the launcher, with its
    variables expanded and quotes removed; comment lines are skipped."""
    with open(path) as f:
        text = f.read().replace("\\\n", " ").replace("`\n", " ")
    env: Dict[str, str] = {}
    calls = []

    def expand(t):
        return _VAR.sub(lambda m: env.get(m.group(1) or m.group(2), m.group(0)), t)

    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        assign = _ASSIGN.match(line)
        if assign:
            value = shlex.split(expand(assign.group(2)), comments=True)
            env[assign.group(1)] = value[0] if value else ""
            continue
        call = _CALL.match(expand(line))
        if call:
            calls.append((call.group(1), shlex.split(call.group(2), comments=True)))
    return calls


def flag_values(argv: List[str]) -> Dict[str, Optional[str]]:
    """{--flag: its value, or None for a switch} of an argv."""
    out: Dict[str, Optional[str]] = {}
    for i, tok in enumerate(argv):
        if tok.startswith("--"):
            nxt = argv[i + 1] if i + 1 < len(argv) else None
            out[tok] = None if nxt is None or nxt.startswith("--") else nxt
    return out
