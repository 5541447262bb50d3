from .funk import ERR_FROZEN, ERR_TXN, Funk, FunkError  # noqa: F401


def make_funk() -> Funk:
    """The authoritative record store: the in-memory `Funk` (the JAX
    package's shared-memory map, funk_native.py, is not ported)."""
    return Funk()
