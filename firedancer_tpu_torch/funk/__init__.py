from .funk import ERR_FROZEN, ERR_KEY, ERR_TXN, Funk, FunkError  # noqa: F401


def make_funk(**kwargs):
    """The authoritative record store, as the JAX leader's default: the
    native shm map (funk_native.NativeFunk; kwargs go to it).  Whoever
    calls this closes what it returns.  A caller who wants the dict store
    passes a `Funk()` where a store is taken (`BankCtx(funk=Funk())`)."""
    from .funk_native import NativeFunk

    return NativeFunk(**kwargs)
