"""Run one of the repository's stdlib report scripts in this process.

``scripts/telemetry_report.py``, ``telemetry_dashboard.py`` and
``postmortem.py`` are run through ``runpy`` with their own ``__main__``
block, as a user runs them, but without a subprocess: the test tiers keep
telemetry and flight-recorder tests in-process.
"""

import contextlib
import io
import os
import runpy
import sys

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts")


def run_script(name: str, *argv: str):
    """``(exit code, stdout)`` of ``scripts/<name> argv...``."""
    path = os.path.join(SCRIPTS, name)
    out = io.StringIO()
    old = sys.argv
    sys.argv = [path, *argv]
    code = 0
    try:
        with contextlib.redirect_stdout(out):
            try:
                runpy.run_path(path, run_name="__main__")
            except SystemExit as e:
                code = e.code if isinstance(e.code, int) else int(bool(e.code))
    finally:
        sys.argv = old
    return code, out.getvalue()
