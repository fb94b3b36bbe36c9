"""Config-path error context for the YAML/TOML decode pipelines.

A loader error used to surface as a bare exception ("timeout must be a
duration string: 5") with no hint WHERE in a 10k-service document the
bad value sits.  :func:`config_path` wraps each decode scope with its
key-path segment; a ``ValueError`` bubbling through gains the joined
path (``services[3].script[1].sleep: ...``) while keeping its ORIGINAL
exception type — unit tests and callers matching on
``InvalidCommandError`` etc. see the same classes, just better
messages.

The path is accumulated on the exception object itself
(``e.config_path`` / ``e.config_base_msg``) so nesting composes from
the inside out without double-prefixing.
"""
from __future__ import annotations

import contextlib
from typing import Iterator


def _join(outer: str, inner: str) -> str:
    if not inner:
        return outer
    if inner.startswith("["):
        return outer + inner
    return f"{outer}.{inner}"


@contextlib.contextmanager
def config_path(segment: str) -> Iterator[None]:
    """Annotate any ValueError escaping this scope with ``segment``.

    Segments compose: ``services[3]`` around ``script`` around ``[1]``
    around ``sleep`` renders as ``services[3].script[1].sleep``.
    """
    try:
        yield
    except ValueError as e:
        prev = getattr(e, "config_path", "")
        base = getattr(e, "config_base_msg", None)
        if base is None:
            base = str(e)
        path = _join(segment, prev)
        e.config_path = path
        e.config_base_msg = base
        e.args = (f"{path}: {base}",)
        raise
