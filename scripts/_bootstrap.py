"""``sys.path`` repair for every ``scripts/*.py`` entry point.

``python scripts/foo.py`` puts ``scripts/`` — not the repo root — on
``sys.path``, so ``import rlsolver_tpu`` would fail. This module puts the
repo root on ``sys.path`` and on ``PYTHONPATH`` (so subprocesses, e.g. the
per-(instance, alg) children of ``scripts/instance_wise.py``, inherit it).

Usage: ``import _bootstrap  # noqa: F401`` as the first import of every
script in this directory.
"""

import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

_cur = [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]
os.environ["PYTHONPATH"] = os.pathsep.join([_REPO] + [p for p in _cur if p != _REPO])
