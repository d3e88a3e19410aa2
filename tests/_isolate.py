"""Run a test in a fresh subprocess (fatal-crash isolation).

Some tests can kill the whole pytest process on this jaxlib (0.9.0):
XLA:CPU collective rendezvous aborts on the 8-virtual-device mesh. The
decorator below re-invokes
pytest for just the decorated test in a child process; the child sees
KAZEN_SUBPROC=1 and runs the real body. Failures (including signals:
abort/segfault) surface as ordinary assertion failures in the parent, so
three consecutive full-suite runs stay green regardless.
"""
import functools
import os
import subprocess
import sys

IN_SUBPROCESS = os.environ.get("KAZEN_SUBPROC") == "1"


def subprocess_isolated(fn):
    """Decorator: run this test in its own pytest subprocess."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if IN_SUBPROCESS:
            return fn(*args, **kwargs)
        test_file = fn.__globals__["__file__"]
        test_id = f"{os.path.abspath(test_file)}::{fn.__name__}"
        env = dict(os.environ, KAZEN_SUBPROC="1")
        r = subprocess.run(
            [sys.executable, "-m", "pytest", "-x", "-q", "-p", "no:cacheprovider", test_id],
            env=env,
            capture_output=True,
            text=True,
            timeout=1800,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(test_file))),
        )
        if r.returncode != 0:
            raise AssertionError(
                f"subprocess-isolated test failed (rc={r.returncode}):\n"
                f"{r.stdout[-6000:]}\n{r.stderr[-3000:]}"
            )

    return wrapper
