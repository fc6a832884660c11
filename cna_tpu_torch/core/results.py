"""Result containers.

The reference returns ``argparse.Namespace`` grab-bags (``_nam.py:168``,
``_association.py:129``).  ``Result`` keeps that ergonomic attribute-style
access (so user code ported from the reference keeps working) while
supporting dict-style construction/update and a readable repr.
"""

from __future__ import annotations

from types import SimpleNamespace


class Result(SimpleNamespace):
    """Attribute-style result namespace (drop-in for argparse.Namespace).

    Supports **lazy fields**: large host-side views (e.g. the samples x
    cells NAM as a labeled DataFrame) are registered as thunks via
    ``set_lazy`` and only materialized — device->host transfer included —
    when first accessed.  The association pipeline keeps everything on
    device; users who read ``res.namresid`` still get the reference's
    DataFrame.
    """

    def set_lazy(self, name, thunk) -> None:
        self.__dict__.setdefault("_lazy", {})[name] = thunk

    def __getattr__(self, name):
        lazy = self.__dict__.get("_lazy")
        if lazy and name in lazy:
            value = lazy.pop(name)()
            setattr(self, name, value)
            return value
        raise AttributeError(
            f"{type(self).__name__!s} object has no attribute {name!r}")

    def update(self, other) -> None:
        if isinstance(other, Result):
            lazy = other.__dict__.get("_lazy")
            if lazy:
                self.__dict__.setdefault("_lazy", {}).update(lazy)
            self.__dict__.update(
                {k: v for k, v in other.__dict__.items() if k != "_lazy"})
            return
        if isinstance(other, SimpleNamespace):
            other = vars(other)
        self.__dict__.update(other)

    def keys(self):
        return self.__dict__.keys()

    def __getitem__(self, key):
        return getattr(self, key)

    def __contains__(self, key):
        return key in self.__dict__ or key in self.__dict__.get("_lazy", {})

    def __repr__(self):
        keys = sorted(
            set(k for k in self.__dict__ if not k.startswith("_"))
            | set(self.__dict__.get("_lazy", {}))
        )
        return f"Result({', '.join(keys)})"
