"""The command line of an experiment script (umhs_torch/scripts/sh/*.sh and
the JAX package's scripts/*.sh): `script_argv(path)` -> (module, argv).

A script holds one `python -m <module> ...` command, its lines joined by
backslash continuations, with comments around it (a commented-out command
among them). The first command that is not a comment is read: its
continuations are joined as bash joins them, and its words are split and
unquoted as bash would (`shlex`). The tests hold each twin's argv to its JAX
script's, and chip_smoke.py runs the twins' argv through the port's CLIs.
"""

from __future__ import annotations

import shlex
from pathlib import Path
from typing import List, Tuple, Union

PYTHONS = ("python", "python3")


def script_argv(path: Union[str, Path]) -> Tuple[str, List[str]]:
    """(the module after `python -m`, the arguments after it) of the
    script's first command; ValueError if it has none."""
    text = Path(path).read_text()
    for line in text.replace("\\\n", "").splitlines():
        words = shlex.split(line, comments=True)
        if not words:
            continue
        if len(words) < 3 or words[0] not in PYTHONS or words[1] != "-m":
            raise ValueError(f"{path}: its command is not `python -m <module> ...`: {line!r}")
        return words[2], words[3:]
    raise ValueError(f"{path}: no command")
