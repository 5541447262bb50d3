"""waltz: the TPU ingress protocol stack, QUIC over TLS 1.3 (the port's copy
of firedancer_tpu/waltz/).

tls13 is the fd_tls counterpart, quic the fd_quic one.  The UDP, stream
and QUIC ingress stages live in runtime/net.py.
"""

from . import quic, tls13  # noqa: F401
