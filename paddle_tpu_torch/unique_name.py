"""Global unique name generator (python/paddle/fluid/unique_name.py parity).

A copy of ``paddle_tpu/unique_name.py``: parameter names must come out
identical in both packages, because weights carry across by name."""

import contextlib

_generator = {}


def generate(key):
    idx = _generator.get(key, 0)
    _generator[key] = idx + 1
    return "%s_%d" % (key, idx)


def switch(new_state=None):
    global _generator
    old = _generator
    _generator = new_state if new_state is not None else {}
    return old


@contextlib.contextmanager
def guard(new_state=None):
    old = switch(new_state)
    try:
        yield
    finally:
        switch(old)
