"""Copy of ``modal_examples_tpu/web/websocket.py``: minimal RFC 6455
websocket server support for the stdlib web gateway.

The reference's streaming-ASR tier serves browser microphones over
websockets through fastapi (06_gpu_and_ml/speech-to-text/
streaming_kyutai_stt.py, streaming_parakeet.py — websocket endpoints that
stream partial transcripts back while audio chunks arrive). fastapi/uvicorn
are optional in this image, so the gateway implements the protocol
directly: handshake (Sec-WebSocket-Accept), frame codec (text/binary/
ping/pong/close, client masking), and a blocking ``WebSocket`` connection
object handlers use as ``ws.receive()`` / ``ws.send_text()``.

Server frames are unmasked, client frames must be masked (RFC 6455 §5.1 —
both enforced). Fragmented messages are reassembled; pings are answered
inline. No extensions/subprotocols (not needed by the workloads).
"""

from __future__ import annotations

import base64
import hashlib
import socket
import struct

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT, OP_TEXT, OP_BINARY = 0x0, 0x1, 0x2
OP_CLOSE, OP_PING, OP_PONG = 0x8, 0x9, 0xA


def accept_key(client_key: str) -> str:
    digest = hashlib.sha1((client_key + _GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def build_frame(opcode: int, payload: bytes, *, fin: bool = True) -> bytes:
    """Server-to-client frame (unmasked)."""
    head = bytes([(0x80 if fin else 0) | opcode])
    n = len(payload)
    if n < 126:
        head += bytes([n])
    elif n < 1 << 16:
        head += bytes([126]) + struct.pack("!H", n)
    else:
        head += bytes([127]) + struct.pack("!Q", n)
    return head + payload


class ConnectionClosed(Exception):
    """Peer closed (or the socket died); carries the close code."""

    def __init__(self, code: int = 1005):
        self.code = code
        super().__init__(f"websocket closed (code={code})")


class WebSocket:
    """Blocking connection; one handler thread per socket.

    Server side by default (unmasked sends, requires masked receives);
    ``client=True`` flips both directions per RFC 6455 §5.1."""

    #: total assembled-message cap (close 1009 beyond it): the gateway
    #: buffers one message per handler thread, so this bounds per-client
    #: memory the way the reference's ASGI servers cap request bodies
    MAX_MESSAGE_BYTES = 32 * 1024 * 1024

    def __init__(self, sock: socket.socket, *, client: bool = False):
        self._sock = sock
        self._buf = b""
        self.closed = False
        self._client = client

    # -- receive ------------------------------------------------------------

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self._sock.recv(65536)
            if not chunk:
                self.closed = True
                raise ConnectionClosed(1006)
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def _read_frame(self) -> tuple[int, bool, bytes]:
        b1, b2 = self._read_exact(2)
        fin = bool(b1 & 0x80)
        opcode = b1 & 0x0F
        masked = bool(b2 & 0x80)
        n = b2 & 0x7F
        if n == 126:
            (n,) = struct.unpack("!H", self._read_exact(2))
        elif n == 127:
            (n,) = struct.unpack("!Q", self._read_exact(8))
        if n > self.MAX_MESSAGE_BYTES:
            # enforce on the DECLARED length before buffering the payload —
            # checking the assembled message only would let one huge frame
            # grow the buffer unbounded first
            self.close(1009)
            raise ConnectionClosed(1009)
        if self._client:
            # server frames are unmasked (a masked one is a protocol error
            # we tolerate by unmasking anyway)
            if masked:
                mask = self._read_exact(4)
                payload = bytearray(self._read_exact(n))
                for i in range(n):
                    payload[i] ^= mask[i % 4]
                return opcode, fin, bytes(payload)
            return opcode, fin, self._read_exact(n)
        if not masked:
            # RFC 6455 §5.1: a server MUST close on unmasked client frames
            self.close(1002)
            raise ConnectionClosed(1002)
        mask = self._read_exact(4)
        payload = bytearray(self._read_exact(n))
        for i in range(n):
            payload[i] ^= mask[i % 4]
        return opcode, fin, bytes(payload)

    def receive(self) -> tuple[str, bytes]:
        """Next complete message -> ("text" | "binary", payload).

        Control frames are handled inline; raises ConnectionClosed on
        close/EOF.
        """
        message = b""
        msg_op = None
        while True:
            opcode, fin, payload = self._read_frame()
            if opcode == OP_PING:
                self._send_raw(self._frame(OP_PONG, payload))
                continue
            if opcode == OP_PONG:
                continue
            if opcode == OP_CLOSE:
                code = (
                    struct.unpack("!H", payload[:2])[0]
                    if len(payload) >= 2 else 1005
                )
                if not self.closed:
                    self._send_raw(self._frame(OP_CLOSE, payload[:2]))
                    self.closed = True
                raise ConnectionClosed(code)
            if opcode in (OP_TEXT, OP_BINARY):
                if msg_op is not None:
                    # RFC 6455 §5.4: a new data frame while a fragmented
                    # message is open is a protocol violation
                    self.close(1002)
                    raise ConnectionClosed(1002)
                msg_op = opcode
                message = payload
            elif opcode == OP_CONT:
                if msg_op is None:
                    # continuation with no message in progress: without
                    # this check a malicious client could grow `message`
                    # unboundedly in the gateway process
                    self.close(1002)
                    raise ConnectionClosed(1002)
                message += payload
            else:
                # RFC 6455 §5.2: reserved opcodes fail the connection —
                # falling through could return a truncated fragmented
                # message as complete
                self.close(1002)
                raise ConnectionClosed(1002)
            if len(message) > self.MAX_MESSAGE_BYTES:
                self.close(1009)  # message too big
                raise ConnectionClosed(1009)
            if fin and msg_op is not None:
                kind = "text" if msg_op == OP_TEXT else "binary"
                return kind, message

    # -- send ---------------------------------------------------------------

    def _send_raw(self, data: bytes) -> None:
        try:
            self._sock.sendall(data)
        except OSError as e:
            self.closed = True
            raise ConnectionClosed(1006) from e

    def _frame(self, opcode: int, payload: bytes) -> bytes:
        if self._client:
            return build_masked_frame(opcode, payload)
        return build_frame(opcode, payload)

    def send_text(self, text: str) -> None:
        self._send_raw(self._frame(OP_TEXT, text.encode()))

    def send_bytes(self, data: bytes) -> None:
        self._send_raw(self._frame(OP_BINARY, data))

    def send_json(self, obj) -> None:
        import json

        self.send_text(json.dumps(obj))

    def close(self, code: int = 1000) -> None:
        if not self.closed:
            self.closed = True
            try:
                self._sock.sendall(
                    self._frame(OP_CLOSE, struct.pack("!H", code))
                )
            except OSError:
                pass


def perform_handshake(handler) -> WebSocket | None:
    """Upgrade an http.server request to a websocket; returns the live
    connection, or None (400 sent) when the upgrade headers are invalid."""
    key = handler.headers.get("Sec-WebSocket-Key")
    if not key:
        # the gateway already routed only Upgrade: websocket requests here
        # (426 otherwise); a missing key is a malformed handshake
        handler.send_response(400)
        handler.end_headers()
        handler.wfile.write(b"missing Sec-WebSocket-Key")
        return None
    # RFC 6455 requires the handshake over HTTP/1.1; http.server's default
    # protocol_version writes an HTTP/1.0 status line, which real browsers
    # reject ("Error during WebSocket handshake")
    handler.protocol_version = "HTTP/1.1"
    handler.send_response(101, "Switching Protocols")
    handler.send_header("Upgrade", "websocket")
    handler.send_header("Connection", "Upgrade")
    handler.send_header("Sec-WebSocket-Accept", accept_key(key))
    handler.end_headers()
    handler.wfile.flush()
    return WebSocket(handler.connection)


def build_masked_frame(opcode: int, payload: bytes, *, fin: bool = True) -> bytes:
    """Client-to-server frame (masked, RFC 6455 §5.1)."""
    import os as _os

    head = bytes([(0x80 if fin else 0) | opcode])
    n = len(payload)
    if n < 126:
        head += bytes([0x80 | n])
    elif n < 1 << 16:
        head += bytes([0x80 | 126]) + struct.pack("!H", n)
    else:
        head += bytes([0x80 | 127]) + struct.pack("!Q", n)
    mask = _os.urandom(4)
    body = bytearray(payload)
    for i in range(n):
        body[i] ^= mask[i % 4]
    return head + mask + bytes(body)


def connect(
    host: str,
    port: int,
    path: str = "/",
    timeout: float = 30.0,
    read_timeout: float | None = None,
) -> WebSocket:
    """Minimal client: TCP connect + upgrade handshake -> WebSocket
    (client mode: masked sends). ``timeout`` bounds the connect+handshake;
    ``read_timeout`` (default None = block forever) applies afterwards —
    a server may legitimately go >30 s between frames (e.g. first-request
    JIT compilation), which must not kill a healthy stream."""
    key = base64.b64encode(hashlib.sha1(str(id(object())).encode()).digest()[:16]).decode()
    sock = socket.create_connection((host, port), timeout=timeout)
    req = (
        f"GET {path} HTTP/1.1\r\n"
        f"Host: {host}:{port}\r\n"
        "Upgrade: websocket\r\n"
        "Connection: Upgrade\r\n"
        f"Sec-WebSocket-Key: {key}\r\n"
        "Sec-WebSocket-Version: 13\r\n\r\n"
    )
    sock.sendall(req.encode())
    buf = b""
    while b"\r\n\r\n" not in buf:
        chunk = sock.recv(4096)
        if not chunk:
            raise ConnectionClosed(1006)
        buf += chunk
    head, rest = buf.split(b"\r\n\r\n", 1)
    status = head.split(b"\r\n", 1)[0]
    if b"101" not in status:
        raise ConnectionError(f"handshake rejected: {status.decode(errors='replace')}")
    want = accept_key(key).encode()
    if want not in head:
        raise ConnectionError("bad Sec-WebSocket-Accept")
    sock.settimeout(read_timeout)
    ws = WebSocket(sock, client=True)
    ws._buf = rest
    return ws
