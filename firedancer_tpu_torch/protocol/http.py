"""HTTP/1.1 requests and responses, cut to what the metrics endpoint needs
(the port's copy of firedancer_tpu/protocol/http.py, the reference's
ballet/http over picohttpparser).

`parse_request` is incremental as picohttpparser is: feed the bytes there
are, and it returns the parsed head with the bytes it took once the blank
line has come, NEED_MORE while the head is incomplete, and raises
HttpError on malformed input.  `MiniServer` serves one request a
connection on a thread of its own, with a bounded body (HttpError answers
400, a handler that raises 500); `build_response` makes a response.

Left out of this copy, waiting for rpc: the response parser, the chunked
body decoder, the websocket upgrade and the streaming responses.
"""

from __future__ import annotations

from dataclasses import dataclass, field

NEED_MORE = None
MAX_HEAD = 64 * 1024
MAX_HEADERS = 100

_TOKEN_OK = set(
    b"!#$%&'*+-.^_`|~0123456789"
    b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
)


class HttpError(ValueError):
    pass


@dataclass
class Request:
    method: str
    path: str
    version: str
    headers: list = field(default_factory=list)  # [(name-lower, value)]
    head_len: int = 0

    def header(self, name: str) -> str | None:
        name = name.lower()
        for k, v in self.headers:
            if k == name:
                return v
        return None


@dataclass
class Response:
    status: int
    reason: str
    version: str
    headers: list = field(default_factory=list)
    head_len: int = 0

    def header(self, name: str) -> str | None:
        name = name.lower()
        for k, v in self.headers:
            if k == name:
                return v
        return None


def _find_head_end(buf: bytes) -> int:
    i = buf.find(b"\r\n\r\n")
    if i < 0:
        if len(buf) > MAX_HEAD:
            raise HttpError("request head too large")
        return -1
    return i + 4


def _parse_headers(lines: list[bytes]) -> list:
    if len(lines) > MAX_HEADERS:
        raise HttpError("too many headers")
    out = []
    for ln in lines:
        if not ln:
            continue
        if ln[:1] in (b" ", b"\t"):  # obs-fold: continuation of previous
            if not out:
                raise HttpError("continuation before first header")
            k, v = out[-1]
            out[-1] = (k, v + " " + ln.strip().decode("latin-1"))
            continue
        sep = ln.find(b":")
        if sep <= 0:
            raise HttpError(f"malformed header line {ln[:40]!r}")
        name = ln[:sep]
        if any(c not in _TOKEN_OK for c in name):
            raise HttpError(f"bad header name {name[:40]!r}")
        out.append(
            (name.decode("latin-1").lower(),
             ln[sep + 1 :].strip().decode("latin-1"))
        )
    return out


def parse_request(buf: bytes) -> Request | None:
    """-> Request (head_len = bytes consumed), NEED_MORE, or raises."""
    end = _find_head_end(buf)
    if end < 0:
        return NEED_MORE
    lines = buf[: end - 4].split(b"\r\n")
    parts = lines[0].split(b" ")
    if len(parts) != 3:
        raise HttpError(f"malformed request line {lines[0][:60]!r}")
    method, path, version = parts
    if not method or any(c not in _TOKEN_OK for c in method):
        raise HttpError("bad method")
    if not version.startswith(b"HTTP/1."):
        raise HttpError(f"unsupported version {version!r}")
    return Request(
        method=method.decode("latin-1"),
        path=path.decode("latin-1"),
        version=version.decode("latin-1"),
        headers=_parse_headers(lines[1:]),
        head_len=end,
    )


def body_length(msg: Request | Response) -> int | str | None:
    """Content-Length as int, 'chunked', or None (read-to-close /
    no body)."""
    te = msg.header("transfer-encoding")
    if te and "chunked" in te.lower():
        return "chunked"
    cl = msg.header("content-length")
    if cl is None:
        return None
    # ascii-digit check: str.isdigit() accepts unicode digits int() rejects
    if not cl or any(c not in "0123456789" for c in cl):
        raise HttpError(f"bad content-length {cl!r}")
    return int(cl)


MAX_BODY = 16 * 1024 * 1024


class MiniServer:
    """A threaded accept loop over parse_request: one request a
    connection, a bounded body, HttpError -> 400.  `handler(request,
    body_bytes) -> response bytes` runs on the connection's thread."""

    def __init__(self, handler, *, host: str = "127.0.0.1", port: int = 0,
                 timeout_s: float = 10.0, max_body: int = MAX_BODY):
        import socket
        import threading

        self._handler = handler
        self._max_body = max_body
        self._timeout = timeout_s
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self._closing = False
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        import threading
        import time

        while not self._closing:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                if self._closing:
                    return
                # transient accept errors (ECONNABORTED, EMFILE, ...)
                # must not kill the server for the process lifetime
                time.sleep(0.05)
                continue
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    def _handle(self, conn):
        conn.settimeout(self._timeout)
        buf = b""
        try:
            try:
                while True:
                    req = parse_request(buf)
                    if req is not NEED_MORE:
                        break
                    chunk = conn.recv(65536)
                    if not chunk:
                        return
                    buf += chunk
                need = body_length(req)
                if need == "chunked":
                    conn.sendall(build_response(400, b"no chunked bodies\n"))
                    return
                need = need or 0
                if need > self._max_body:
                    # cap BEFORE buffering: an attacker-controlled
                    # Content-Length must not grow memory unbounded
                    conn.sendall(build_response(400, b"body too large\n"))
                    return
                while len(buf) - req.head_len < need:
                    chunk = conn.recv(65536)
                    if not chunk:
                        return
                    buf += chunk
            except HttpError:
                try:
                    conn.sendall(build_response(400, b"bad request\n"))
                except OSError:
                    pass
                return
            body = buf[req.head_len : req.head_len + need]
            try:
                resp = self._handler(req, body)
            except Exception:
                # a handler bug must answer 500, not strand the client
                # until its timeout with a silent close
                resp = build_response(500, b"internal error\n")
            conn.sendall(resp)
        except OSError:
            pass
        finally:
            conn.close()

    @property
    def addr(self):
        return self._sock.getsockname()

    def close(self):
        self._closing = True
        try:
            self._sock.close()
        except OSError:
            pass


def build_response(status: int, body: bytes = b"", *, content_type: str = "text/plain",
                   headers: list | None = None) -> bytes:
    """A whole response: the head (content-length declared, and
    `connection: close`, as MiniServer serves one request a connection)
    and the body."""
    reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
              405: "Method Not Allowed", 500: "Internal Server Error"}.get(status, "")
    head = [f"HTTP/1.1 {status} {reason}".encode()]
    head.append(b"content-type: " + content_type.encode())
    head.append(b"content-length: " + str(len(body)).encode())
    head.append(b"connection: close")
    for k, v in headers or []:
        head.append(f"{k}: {v}".encode())
    return b"\r\n".join(head) + b"\r\n\r\n" + body
