"""The JAX package's host library (`dcf.native`) for the port's tests that
compare with it: loaded whole, once a process.

`dcf.native.get_lib` compiles straight into the library's final path and
remembers a failed load for the rest of the process. Every xdist worker
collects `tests/test_native.py`, which calls it, so in a fresh checkout a
worker can load the file while another still writes it, and then sees no
library in every later test. `load()` takes an exclusive `flock` on the
library's directory, so the port's test processes build it one at a time,
and while `get_lib()` gives None it forgets the failure and loads again,
for up to `TIMEOUT_S`: long enough for another process's build to end.
"""

import fcntl
import functools
import os
import time

from dcf import native as jnative

TIMEOUT_S = 120.0


@functools.cache
def load():
    """`dcf.native.get_lib()` once it loads, or None after `TIMEOUT_S`."""
    fd = os.open(os.path.dirname(os.path.abspath(jnative.__file__)),
                 os.O_RDONLY)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        deadline = time.monotonic() + TIMEOUT_S
        while jnative.get_lib() is None and time.monotonic() < deadline:
            time.sleep(0.5)
            jnative._tried = False
        return jnative.get_lib()
    finally:
        os.close(fd)
