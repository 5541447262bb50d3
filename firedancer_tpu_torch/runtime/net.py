"""Ingress: real packets off a socket into the pipeline (the port's copy of
firedancer_tpu/runtime/net.py).

Three stages, one receive loop:

  - `UdpIngressStage`: the plain-UDP TPU port, one datagram = one whole
    transaction.  Oversized datagrams (> TXN_MTU) are dropped and counted
    (fd_quic's MTU policy).  With native_net=True (the default) a burst is
    one native sweep (runtime/net_native.py over native/fd_net.cpp): one
    recvmmsg crossing into the C out arena, then one publish_burst_out; the
    credit-gated tail stays queued in C, never dropped.  native_net=False
    is the Python receive loop, one recvfrom a datagram.
  - `StreamIngressStage`: datagrams carrying stream frames, reassembled
    (runtime/tpu_reasm.py) into whole txns; the slot is keyed by sender.
  - `QuicIngressStage`: QUIC v1 off the socket (waltz/quic.py over
    waltz/tls13.py), one server connection a peer address, stream chunks
    through the reassembler.  With native_net=True every datagram goes to
    the C short-header fast path first; whatever the C side cannot own
    (long headers, unknown CIDs, migration, control frames) punts to the
    Python connection in arrival order, and the C side's events are
    replayed into that connection after every crossing, so waltz/quic.py
    stays the single source of truth for the control plane.

Every stage is nonblocking: each loop iteration drains up to `rx_burst`
datagrams into the out link (credits permitting), so the cooperative
scheduler never stalls on an idle socket.  `send_txns`,
`send_stream_txn` and `QuicTxnClient` are the sending side.
"""

from __future__ import annotations

import errno
import hashlib
import os
import socket
import struct
import time

from ..protocol.txn import TXN_MTU
from ..waltz import quic, tls13
from . import net_native
from .stage import Stage
from .tpu_reasm import TpuReasm


class UdpIngressStage(Stage):
    # the native recvmmsg sweep bypasses _on_datagram entirely, so only the
    # class whose per-datagram handling IS "publish the raw bytes" takes
    # it; framed subclasses keep the Python receive loop and hook the
    # native client at their own seam (QuicIngressStage) or not at all
    # (StreamIngressStage)
    _NATIVE_UDP = True

    def __init__(
        self,
        *args,
        host: str = "127.0.0.1",
        port: int = 0,
        sock: socket.socket | None = None,
        rx_burst: int = 64,
        native_net: bool = True,
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        if sock is None:
            sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            sock.bind((host, port))
        sock.setblocking(False)
        self.sock = sock
        self.rx_burst = rx_burst
        self._net_client = self._open_net_client() if native_net else None

    def _open_net_client(self):
        if not self._NATIVE_UDP:
            return None
        return net_native.NetClient(max_conns=1, reasm_depth=1)

    @property
    def addr(self) -> tuple[str, int]:
        return self.sock.getsockname()

    def after_credit(self) -> None:
        """One receive loop for every ingress flavor; subclasses override
        only the per-datagram handling (_on_datagram)."""
        if self._NATIVE_UDP and self._net_client is not None:
            self.native_sweep()
            return
        self._py_recv_loop()

    def _py_recv_loop(self) -> None:
        """The Python lane: one recvfrom a datagram."""
        for _ in range(self.rx_burst):
            try:
                data, src = self.sock.recvfrom(2048)
            except (BlockingIOError, InterruptedError):
                return
            except OSError as e:
                if e.errno in (errno.EAGAIN, errno.EWOULDBLOCK):
                    return
                raise
            if not self._on_datagram(data, src):
                return  # backpressured: stop draining the socket

    def native_sweep(self, scalar: bool = False) -> None:
        """One burst through the native client: one crossing drains the
        socket into the C out arena (recvmmsg, the kernel scattering each
        datagram into its slot), one burst publishes it.  The credit-gated
        tail stays queued on the native side, never dropped.  scalar=True
        takes NetClient.udp_sweep_scalar (one recv a datagram, the same
        rows and counters), which only an explicit call reaches."""
        nc = self._net_client
        # the plane is built lazily on the stage's registry: re-arm whenever
        # the stage's plane is rebuilt
        plane = self._native_plane()
        if plane is not nc._plane:
            nc.set_metrics(plane)
        oi = net_native.COUNTER_IDX["oversz"]
        before = int(nc.counters_view[oi])
        sweep = nc.udp_sweep_scalar if scalar else nc.udp_sweep
        sweep(self.sock.fileno(), self.rx_burst)
        oversz = int(nc.counters_view[oi]) - before
        if oversz:
            self.metrics.inc("oversize_drop", oversz)
        n = nc.out_count()
        if not n:
            return
        # sig follows the Python lane's running pkt_rx; the arithmetic keeps
        # a retried tail's sigs stable across sweeps
        base = self.metrics.get("pkt_rx")
        items = [(nc.out_txn(i), base + 1 + i, 0) for i in range(n)]
        done = self.publish_burst_out(0, items)
        nc.out_pop(done)
        if done:
            self.metrics.inc("pkt_rx", done)
        if done < n:
            self.metrics.inc("pkt_drop_backpressure", n - done)

    def _on_datagram(self, data: bytes, src) -> bool:
        """Handle one datagram; False = stop the burst (backpressure)."""
        if len(data) > TXN_MTU:
            self.metrics.inc("oversize_drop")
            return True
        self.metrics.inc("pkt_rx")
        if not self.publish(0, data, sig=self.metrics.get("pkt_rx")):
            self.metrics.inc("pkt_drop_backpressure")
            return False
        return True

    def close(self) -> None:
        if self._net_client is not None:
            self._net_client.close()
            self._net_client = None
        self.sock.close()


def send_txns(addr: tuple[str, int], txns: list[bytes]) -> None:
    """Send each txn as one datagram at a UDP ingress (the benchs sender)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        for t in txns:
            s.sendto(t, addr)
    finally:
        s.close()


def send_paced(sock: socket.socket, stage: UdpIngressStage, txns: list[bytes], sent: int,
               ahead: int = 128) -> int:
    """Send txns[sent:] from `sock` at `stage.addr`, one datagram a txn,
    until `ahead` datagrams are past the stage's pkt_rx; returns how many
    of txns are sent.  Loopback UDP drops silently past the receive
    buffer, so the sender waits for the stage rather than resend: call it
    between the stage's sweeps until pkt_rx reaches len(txns)."""
    while sent < len(txns) and sent - stage.metrics.get("pkt_rx") < ahead:
        sock.sendto(txns[sent], stage.addr)
        sent += 1
    return sent


# -- stream ingress: multi-datagram txns through the reassembler --------------
#
# A txn larger than one datagram arrives as stream FRAMES that reassemble
# before verify.  The frame format (this framework's stream framing; QUIC
# replaces the outer layer, the reassembly discipline stays):
#     "FDST" | u64 conn_id | u32 stream_id | u8 flags (1 = FIN) | data

_FRAME_HDR = struct.Struct("<8sQIB")
_FRAME_MAGIC = b"FDST\x00\x00\x00\x00"


def encode_stream_frame(conn_id: int, stream_id: int, data: bytes, fin: bool) -> bytes:
    return _FRAME_HDR.pack(_FRAME_MAGIC, conn_id, stream_id, 1 if fin else 0) + data


class StreamIngressStage(UdpIngressStage):
    """UDP datagrams carrying stream frames -> reassembled whole txns.

    The same socket scaffolding and receive loop as UdpIngressStage: each
    datagram is a stream FRAME fed through the reassembler; whole txns
    publish downstream.  One-frame streams take the same slot logic.
    """

    _NATIVE_UDP = False  # frames need the per-datagram parse below

    def __init__(self, *args, reasm_depth: int = 64, **kwargs):
        super().__init__(*args, **kwargs)
        self.reasm = TpuReasm(depth=reasm_depth)

    def _on_datagram(self, data: bytes, src) -> bool:
        if len(data) < _FRAME_HDR.size:
            self.metrics.inc("bad_frame")
            return True
        magic, conn_id, stream_id, flags = _FRAME_HDR.unpack_from(data)
        if magic != _FRAME_MAGIC:  # all 8 bytes, not a 4-byte prefix
            self.metrics.inc("bad_frame")
            return True
        self.metrics.inc("frame_rx")
        # the slot key includes the SENDER: peer-chosen (conn, stream) ids
        # must never interleave two peers' frames or let one peer poison
        # another's in-flight stream (QUIC's conn identity plays this role;
        # the UDP source address is its stand-in here)
        txn = self.reasm.append((src, conn_id, stream_id), data[_FRAME_HDR.size:],
                                fin=bool(flags & 1))
        if txn is None:
            return True
        self.metrics.inc("txn_rx")
        if not self.publish(0, txn, sig=self.metrics.get("txn_rx")):
            self.metrics.inc("txn_drop_backpressure")
            return False
        return True


def send_stream_txn(addr: tuple[str, int], txn: bytes, *, conn_id: int = 1,
                    stream_id: int = 0, frame_sz: int = 512) -> None:
    """Send one txn as a fragmented stream."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        if not txn:  # an empty payload still ends with an explicit FIN frame
            s.sendto(encode_stream_frame(conn_id, stream_id, b"", True), addr)
            return
        for off in range(0, len(txn), frame_sz):
            chunk = txn[off:off + frame_sz]
            fin = off + frame_sz >= len(txn)
            s.sendto(encode_stream_frame(conn_id, stream_id, chunk, fin), addr)
    finally:
        s.close()


# the exceptions one bad datagram may raise in the Python connection, each
# dropped with the datagram: untrusted bytes reach struct unpacking (a
# truncated ClientHello: struct.error, IndexError) and x25519 (an all-zero
# key share: ValueError), and the stage loop has no catch-all, so any other
# escape would be a remote DoS of the TPU ingress
_BAD_DATAGRAM = (quic.QuicError, tls13.TlsError, ValueError, IndexError, KeyError,
                 struct.error)


class QuicIngressStage(UdpIngressStage):
    """The QUIC/TPU server position (the fd_quic tile): QUIC v1 packets off
    the UDP socket, one waltz.quic server connection a peer address,
    the handshake through the embedded TLS engine, stream chunks through
    the TPU reassembler, whole txns published downstream.

    The stage owns the server's Ed25519 identity (QUIC's certificate
    self-signing is the one role fd_tls keeps near the socket).  With
    native_net=True (the default) established connections export their rx
    application keys into the C table and their short-header datagrams
    never touch Python crypto; native_net=False runs every datagram
    through the Python connection."""

    _NATIVE_UDP = False  # the native seam is the QUIC datagram path

    def __init__(self, *args, identity_secret: bytes, reasm_depth: int = 64,
                 max_conns: int = 64, retry: bool = False, **kwargs):
        self.max_conns = max_conns
        self._reasm_depth = reasm_depth
        super().__init__(*args, **kwargs)
        self.identity_secret = identity_secret
        self.conns: dict = {}
        self._addr_by_cid: dict = {}   # server CID -> current peer addr
        self._migrations: dict = {}    # CID -> (candidate addr, token)
        self.reasm = TpuReasm(depth=reasm_depth)
        # address validation: with retry=True an unvalidated Initial costs
        # a STATELESS Retry, never a connection slot or a handshake (the
        # amplification defense on the public TPU port)
        static = hashlib.sha256(b"quic-static:" + identity_secret).digest()
        self.retry_required = retry
        self.retry_gate = quic.RetryGate(static)
        self._reset_key = static
        # RFC 9000 §8: until an address is validated, send at most 3x what
        # it sent us (tracked pre-handshake only; validated addrs drop out)
        # src -> [rx_bytes, tx_bytes, created_monotonic_s]
        self._addr_budget: dict = {}
        # the native client's bookkeeping: the event drain keeps the Python
        # Connection authoritative (tracker, acks, rx windows), so the
        # control plane and every punt stay correct
        self._addr_ids: dict = {}     # src -> interned u32 addr id
        self._native_idx: dict = {}   # local cid bytes -> native idx
        self._by_idx: dict = {}       # native idx -> Connection
        self._native_src: dict = {}   # native idx -> current home addr

    def _open_net_client(self):
        return net_native.NetClient(max_conns=self.max_conns, reasm_depth=self._reasm_depth)

    def _send(self, dg: bytes, dst) -> None:
        budget = self._addr_budget.get(dst)
        if budget is not None:
            # §8.1 anti-amplification: an unvalidated path gets at most 3x
            # the bytes it sent; the surplus waits for more from the peer
            # (PTO resends it), so a spoofed victim address can never be
            # used as an amplifier
            if budget[1] + len(dg) > 3 * budget[0]:
                self.metrics.inc("tx_amplification_capped")
                return
            budget[1] += len(dg)
        self.sock.sendto(dg, dst)

    def after_credit(self) -> None:
        if self._net_client is not None:
            # retry the credit-gated native txn tail before taking more off
            # the socket: queued-never-dropped needs a drain point that does
            # not depend on further ingress
            self._flush_native_txns()
        super().after_credit()
        # loss-recovery housekeeping: fire PTO retransmissions even when the
        # socket is quiet (a lost server flight must not deadlock the
        # handshake)
        for src, conn in list(self.conns.items()):
            conn.poll_timers()
            for dg in conn.flush():
                self._send(dg, src)

    def _on_datagram(self, data: bytes, src) -> bool:
        """Native-first dispatch: the C fast path either consumes the
        datagram (short header, known conn, consumable frame mix), drops it
        (auth/flow/frame violations: byte for byte the Python lane's
        verdict), or punts it to the Python connection in arrival order."""
        nc = self._net_client
        if nc is None:
            return self._py_datagram(data, src)
        plane = self._native_plane()
        if plane is not nc._plane:
            nc.set_metrics(plane)
        rc = nc.datagram(data, self._intern_addr(src))
        if rc == net_native.RC_CONSUMED:
            self.metrics.inc("pkt_rx")
            return self._drain_native(src)
        if rc == net_native.RC_DROP:
            self._drain_native(src)
            self.metrics.inc("bad_packet")
            return True
        return self._punt(data, src)

    def _intern_addr(self, src) -> int:
        aid = self._addr_ids.get(src)
        if aid is None:
            aid = len(self._addr_ids) + 1
            self._addr_ids[src] = aid
        return aid

    def _punt(self, data: bytes, src) -> bool:
        """The Python connection handles a datagram the native side
        declined, then the state re-syncs: the pns, windows and address the
        Python connection just advanced push back down, so the C table
        never goes stale."""
        conn = self.conns.get(src)
        prev = None
        if conn is not None:
            idx = self._native_idx.get(bytes(conn.local_cid))
            if idx is not None:
                prev = (conn, idx,
                        [(int(r[0]), int(r[1])) for r in conn.recv[quic.APPLICATION].ranges])
        ok = self._py_datagram(data, src)
        if prev is not None:
            self._sync_after_punt(*prev, src)
        else:
            self._maybe_export(src)
        return ok

    def _maybe_export(self, src) -> None:
        """Install a newly established connection's rx side into the native
        table (or re-home an exported one after migration)."""
        nc = self._net_client
        conn = self.conns.get(src)
        if nc is None or conn is None or not conn.established:
            return
        cid = bytes(conn.local_cid)
        idx = self._native_idx.get(cid)
        if idx is not None:
            if self._native_src.get(idx) != src:
                nc.conn_set_addr(idx, self._intern_addr(src))
                self._native_src[idx] = src
            return
        keys = quic.export_rx_app_keys(conn)
        if keys is None:
            return
        key, iv, hp = keys
        ranges = [(int(lo), int(hi)) for lo, hi in conn.recv[quic.APPLICATION].ranges]
        idx = nc.conn_add(cid, self._intern_addr(src), key, iv, hp, ranges,
                          conn.rx_max_data, conn.rx_data_total)
        if idx >= 0:
            self._native_idx[cid] = idx
            self._by_idx[idx] = conn
            self._native_src[idx] = src
            self.metrics.inc("net_conn_exported")

    def _sync_after_punt(self, conn, idx: int, old_ranges, src) -> None:
        nc = self._net_client
        if conn.closed:
            self._native_remove(conn)
            return
        # pns the Python lane just admitted (at most the packets of one
        # datagram) feed the native dedup window
        for lo, hi in ((int(r[0]), int(r[1])) for r in conn.recv[quic.APPLICATION].ranges):
            cur = lo
            for olo, ohi in old_ranges:
                if ohi < cur or olo > hi:
                    continue
                for pn in range(cur, min(olo - 1, hi) + 1):
                    nc.conn_pn_add(idx, pn)
                cur = max(cur, ohi + 1)
                if cur > hi:
                    break
            for pn in range(cur, hi + 1):
                nc.conn_pn_add(idx, pn)
        nc.conn_window(idx, conn.rx_max_data, conn.rx_data_total)
        if self.conns.get(src) is conn and self._native_src.get(idx) != src:
            nc.conn_set_addr(idx, self._intern_addr(src))  # migrated
            self._native_src[idx] = src

    def _native_remove(self, conn) -> None:
        idx = self._native_idx.pop(bytes(conn.local_cid), None)
        if idx is not None:
            self._net_client.conn_remove(idx)
            self._by_idx.pop(idx, None)
            self._native_src.pop(idx, None)

    def _drain_native(self, src) -> bool:
        """Replay the C side's events into the authoritative Python
        connections (tracker, ack, rtt and window state), publish the
        completed txns (credit-gated; the tail stays queued on the native
        side), and flush each touched connection's ACKs exactly as the
        Python lane would."""
        nc = self._net_client
        now = time.monotonic()
        nev = nc.event_count()
        ev = nc.events
        touched = set()
        for i in range(nev):
            idx = int(ev[i, 1])
            conn = self._by_idx.get(idx)
            if conn is None:
                continue
            typ = int(ev[i, 0])
            a = int(ev[i, 2])
            b = int(ev[i, 3])
            if typ == net_native.EV_PKT:
                conn._processed_any = True
                if b != 1:  # a dup re-acks only, never re-adds
                    conn.recv[quic.APPLICATION].add(a)
                if b in (0, 1):  # ack-eliciting or dup
                    conn.ack_pending.add(quic.APPLICATION)
                touched.add(idx)
            elif typ == net_native.EV_ACK:
                conn._on_ack(quic.APPLICATION, [(a - b, a)], now)
                touched.add(idx)
            elif typ == net_native.EV_WIN:
                conn.rx_consumed += a
                conn.rx_data_total += b
                if conn.rx_consumed * 2 > conn.rx_max_data:
                    # the MAX_DATA advertisement of _rx_window_updates,
                    # pushed back down so the native flow check tracks it
                    conn.rx_max_data = conn.rx_consumed + quic.DEFAULT_MAX_DATA
                    conn.ctrl_out.append(bytes([quic.FT_MAX_DATA])
                                         + quic.varint_encode(conn.rx_max_data))
                    nc.conn_window(idx, conn.rx_max_data, conn.rx_data_total)
                touched.add(idx)
        if nev:
            nc.events_clear()
        ok = self._flush_native_txns()
        for idx in touched:
            conn = self._by_idx.get(idx)
            if conn is None:
                continue
            home = self._native_src.get(idx, src)
            for dg in conn.flush():
                self._send(dg, home)
        return ok

    def _flush_native_txns(self) -> bool:
        nc = self._net_client
        n = nc.out_count()
        if not n:
            return True
        base = self.metrics.get("txn_rx")
        items = [(nc.out_txn(i), base + 1 + i, 0) for i in range(n)]
        done = self.publish_burst_out(0, items)
        nc.out_pop(done)
        if done:
            self.metrics.inc("txn_rx", done)
        if done < n:
            self.metrics.inc("txn_drop_backpressure", n - done)
            return False
        return True

    def net_counters(self) -> dict:
        """The native client's counter block ({} on the Python lane)."""
        nc = self._net_client
        return nc.counters() if nc is not None else {}

    def _py_datagram(self, data: bytes, src) -> bool:
        conn = self.conns.get(src)
        fresh = conn is None
        migrating_cid = None
        if fresh:
            # connection migration (RFC 9000 §9): an unknown address whose
            # packet carries a KNOWN connection id belongs to an established
            # peer that changed path: look the conn up by CID, process
            # normally, and validate the new path with a PATH_CHALLENGE
            # before replies move there
            cid = quic.peek_dcid(data, short_dcid_len=8)
            home = self._addr_by_cid.get(cid) if cid else None
            if home is not None and home in self.conns:
                conn = self.conns[home]
                fresh = False
                migrating_cid = cid
        if fresh:
            ver = quic.packet_version(data)
            if ver is None:
                # a short header from an unknown address with an unknown
                # CID: a stateless reset keyed to that CID (§10.3), so a
                # rebooted peer's connection dies fast, not by timeout
                cid = quic.peek_dcid(data, short_dcid_len=8)
                if cid and len(data) >= 43:
                    self._send(quic.build_stateless_reset(
                        quic.stateless_reset_token(self._reset_key, cid)), src)
                    self.metrics.inc("stateless_reset_tx")
                return True
            if ver == 0:
                return True  # §6.1: never answer VN with VN
            if ver != quic.QUIC_V1:
                # §6: a long header in a version we don't speak gets a
                # Version Negotiation response, for big enough datagrams only
                # (tiny spoofed probes get nothing)
                if len(data) >= 1200 and len(data) > 6:
                    dlen = data[5]
                    dcid = data[6:6 + dlen]
                    so = 6 + dlen
                    scid = data[so + 1:so + 1 + data[so]] if len(data) > so else b""
                    self._send(quic.build_version_negotiation(scid, dcid), src)
                    self.metrics.inc("version_negotiation_tx")
                return True
            if len(data) < 1200:
                # §14.1: servers MUST discard Initials in datagrams smaller
                # than 1200 bytes, and never answer them (a tiny spoofed
                # Initial must not amplify via Retry)
                self.metrics.inc("small_initial_dropped")
                return True
            if self.retry_required:
                peek = quic.peek_initial_token(data)
                if peek is None:
                    self.metrics.inc("bad_packet")
                    return True
                dcid, scid, token = peek
                odcid = self.retry_gate.validate(src, token) if token else None
                if odcid is None:
                    # STATELESS: no conn, no TLS, just a Retry carrying a
                    # token bound to (src, original dcid)
                    self._send(quic.build_retry(
                        odcid=dcid, dcid=scid, scid=os.urandom(8),
                        token=self.retry_gate.make_token(src, dcid)), src)
                    self.metrics.inc("retry_tx")
                    return True
            if len(self.conns) >= self.max_conns and not self._evict():
                self.metrics.inc("conn_drop")
                return True
            if not self.retry_required and src not in self._addr_budget:
                # no token validation: the 3x budget guards this address
                # until its handshake completes.  FAIL CLOSED when the
                # tracking table is full (evicting a LIVE unvalidated entry
                # would exempt that path from the cap), but entries past the
                # handshake deadline with no live conn are reclaimable, else
                # a spray of spoofed Initials locks out new clients forever
                now = time.monotonic()
                if len(self._addr_budget) >= 4 * self.max_conns:
                    for a in [a for a, b in self._addr_budget.items()
                              if now - b[2] > 30.0 and a not in self.conns]:
                        del self._addr_budget[a]
                if len(self._addr_budget) >= 4 * self.max_conns:
                    self.metrics.inc("addr_budget_full_drop")
                    return True
                self._addr_budget[src] = [0, 0, now]
            conn = quic.Connection.server_new(self.identity_secret)
        if src in self._addr_budget:
            self._addr_budget[src][0] += len(data)
            if conn is not None and conn.established:
                del self._addr_budget[src]  # address validated
        try:
            events = conn.receive(data)
        except _BAD_DATAGRAM:
            # drop the bad packet only: a fresh conn that failed its first
            # datagram never occupies a slot (garbage sprayers can't fill
            # max_conns), and an ESTABLISHED conn survives spoofed noise
            # aimed at its address (RFC 9000: discard undecryptable
            # packets, never tear down)
            self.metrics.inc("bad_packet")
            return True
        if fresh:
            self.conns[src] = conn
            self._addr_by_cid[bytes(conn.local_cid)] = src
        self.metrics.inc("pkt_rx")
        home = self._addr_by_cid.get(migrating_cid, src) if migrating_cid else src
        if migrating_cid is not None:
            # complete or advance path validation for the new address
            pend = self._migrations.get(migrating_cid)
            if pend is not None and any(r == pend[1] for r in conn.path_responses):
                conn.path_responses.clear()
                del self._migrations[migrating_cid]
                old = self._addr_by_cid[migrating_cid]
                self.conns.pop(old, None)
                self.conns[src] = conn
                self._addr_by_cid[migrating_cid] = src
                home = src
                self.metrics.inc("migrated")
            elif pend is None or pend[0] != src:
                token = os.urandom(8)
                self._migrations[migrating_cid] = (src, token)
                probe = conn.probe_datagram(bytes([quic.FT_PATH_CHALLENGE]) + token)
                if probe is not None:
                    self._send(probe, src)
                    self.metrics.inc("path_challenge_tx")
        for dg in conn.flush():
            self._send(dg, home)
        ok = True
        nc = self._net_client
        idx = self._native_idx.get(bytes(conn.local_cid)) if nc is not None else None
        for sid, chunk, fin in conn.receive_stream_events(events):
            if idx is not None and nc.conn_stream_is_done(idx, sid):
                continue  # the fast path delivered it whole: a retransmission
            # every chunk feeds reassembly even under backpressure: the
            # datagram is already ACKed, so a skipped chunk would be a
            # permanent hole in its stream; only completed txns can drop
            txn = self.reasm.append((src, sid), chunk, fin=fin)
            if txn is None:
                continue
            if idx is not None:
                nc.conn_stream_done(idx, sid)
            if not self.publish(0, txn, sig=self.metrics.get("txn_rx") + 1):
                self.metrics.inc("txn_drop_backpressure")
                ok = False
                continue
            self.metrics.inc("txn_rx")
        return ok

    def _evict(self) -> bool:
        """Drop a closed or not-yet-established connection to make room
        (handshake-stalled peers lose their slot first)."""
        for src, conn in list(self.conns.items()):
            if conn.closed or not conn.established:
                del self.conns[src]
                if self._net_client is not None:
                    self._native_remove(conn)
                self.metrics.inc("conn_evict")
                return True
        return False


class QuicTxnClient:
    """Handshakes to a QuicIngressStage and ships txns, one client-initiated
    unidirectional stream (ids 2, 6, 10, ...) a txn: the benchs sender
    position over QUIC."""

    def __init__(self, addr, *, expected_peer: bytes | None = None,
                 timeout_s: float = 10.0):
        self.addr = addr
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.settimeout(0.05)
        self.conn = quic.Connection.client_new(expected_peer=expected_peer)
        self._next_stream = 2
        deadline = time.monotonic() + timeout_s
        self._flush_out()
        while not self.conn.established:
            try:
                data, _ = self.sock.recvfrom(2048)
                self.conn.receive(data)
            except socket.timeout:
                pass
            # PTO keeps a lossy handshake moving (lost Initial/Handshake
            # flights retransmit; without this a single drop deadlocks)
            self.conn.poll_timers()
            self._flush_out()
            if time.monotonic() > deadline:
                raise TimeoutError("QUIC handshake timed out")

    def _flush_out(self) -> None:
        for dg in self.conn.flush():
            self.sock.sendto(dg, self.addr)

    def _drain_rx(self) -> None:
        """Nonblocking drain of inbound datagrams (acks, MAX_DATA window
        updates); the socket's handshake timeout is restored after."""
        self.sock.setblocking(False)
        try:
            while True:
                try:
                    data, _ = self.sock.recvfrom(2048)
                except (BlockingIOError, InterruptedError, socket.timeout):
                    break
                self.conn.receive(data)
        finally:
            self.sock.settimeout(0.05)

    def send_txn(self, txn: bytes) -> None:
        # learn window updates BEFORE queueing: past ~1 MiB cumulative the
        # peer's MAX_DATA must be seen or writes park in blocked_out
        self._drain_rx()
        sid = self._next_stream
        self._next_stream += 4
        self.conn.send_stream(sid, txn, fin=True)
        self._flush_out()

    def pump(self) -> None:
        """Process inbound datagrams (acks, window updates) and fire any due
        retransmissions.  Call while waiting for delivery on lossy links or
        during long send loops (flow-control windows only move when inbound
        MAX_DATA frames are read)."""
        self._drain_rx()
        self.conn.poll_timers()
        self._flush_out()

    def unacked(self) -> bool:
        """True while sent stream data is not yet fully acknowledged."""
        return self.conn.has_unacked()

    def close(self) -> None:
        self.sock.close()
