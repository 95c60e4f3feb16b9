"""Seams into the program for the length of a session: attributes of the
program's modules replaced and put back, and the RANSAC draws the program
makes kept for the units the check samples."""
from __future__ import annotations

import functools
import importlib


class Patches:
    """Replaces module attributes while active and puts them back on exit.
    A target the program no longer has is skipped (``set`` returns
    False)."""

    def __init__(self):
        self._saved = []

    def set(self, target: str, wrap) -> bool:
        """Replace ``module:attr`` (or ``module:attr[key]`` of a dict) with
        ``wrap(original)``."""
        obj, key = resolve(target)
        if obj is None:
            return False
        if isinstance(obj, dict):
            old = obj[key]
            obj[key] = wrap(old)
        else:
            old = getattr(obj, key)
            setattr(obj, key, wrap(old))
        self._saved.append((obj, key, old))
        return True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for obj, key, old in reversed(self._saved):
            if isinstance(obj, dict):
                obj[key] = old
            else:
                setattr(obj, key, old)
        self._saved.clear()


def resolve(target: str):
    """``(holder, key)`` of ``"pkg.module:attr"`` or ``"pkg.module:attr[key]"``,
    or ``(None, None)`` where the module or the attribute is gone."""
    mod_name, _, attr = target.partition(":")
    try:
        holder = importlib.import_module(mod_name)
    except ImportError:
        return None, None
    key = None
    if attr.endswith("]"):
        attr, _, key = attr[:-1].partition("[")
    if not hasattr(holder, attr):
        return None, None
    if key is None:
        return holder, attr
    d = getattr(holder, attr)
    return (d, key) if isinstance(d, dict) and key in d else (None, None)


class Draws:
    """Keeps the hypotheses ``draw_samples`` returns while ``active``."""

    def __init__(self):
        self.active = False
        self.got = []

    def wrap(self, fn):
        @functools.wraps(fn)
        def draw(*args, **kwargs):
            out = fn(*args, **kwargs)
            if self.active:
                self.got.append(out)
            return out
        return draw

    def take(self) -> list:
        got, self.got = self.got, []
        return got


DRAW_TARGET = "caelo_tpu_torch.frontend.ransac:draw_samples"
