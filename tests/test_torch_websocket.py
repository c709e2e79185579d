"""The port's websocket layer (``web/websocket.py``, the gateway's
``@websocket_endpoint`` branch) held against the JAX package's: the
handshake key and the server and client frame codecs byte for byte (fixed
masks; payload lengths at each length-encoding edge; close codes), the
port's server with the reference's client and the reverse (fragmented
messages, pings), and the streaming-ASR events of tiny Whisper served by
each package's gateway for the same PCM chunks (weights carried across by
``whisper.params_from_jax``; modelled on ``tests/test_streaming_asr.py``).
"""

import json
import os
import socket
import struct

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from modal_examples_tpu.core.app import load_module_from_path as jload
from modal_examples_tpu.models import whisper as jwhisper
from modal_examples_tpu.web import gateway as jgateway
from modal_examples_tpu.web import websocket as jws
from modal_examples_tpu_torch.core.app import load_module_from_path
from modal_examples_tpu_torch.models import whisper as twhisper
from modal_examples_tpu_torch.utils import audio as taudio
from modal_examples_tpu_torch.web import gateway as pgateway
from modal_examples_tpu_torch.web import websocket as pws
from test_torch_time_limit import share_cores, time_limits

share_cores()

#: the ASR case traces tiny Whisper in JAX (~10 s); the others take a second
_limit_module, _limit_test = time_limits(test_s=120, module_s=120)

LENGTHS = [0, 1, 125, 126, 65535, 65536]
OPCODES = [pws.OP_TEXT, pws.OP_BINARY, pws.OP_PING, pws.OP_PONG, pws.OP_CONT]


def _payload(n: int) -> bytes:
    return (bytes(range(256)) * (n // 256 + 1))[:n]


@pytest.mark.parametrize("key", ["dGhlIHNhbXBsZSBub25jZQ==", "x3JJHMbDL1EzLkh9GBhXDw==", ""])
def test_accept_key_equals_the_references(key):
    assert pws.accept_key(key) == jws.accept_key(key)
    if key == "dGhlIHNhbXBsZSBub25jZQ==":  # RFC 6455 section 1.3's example
        assert pws.accept_key(key) == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("opcode", OPCODES)
def test_server_frames_equal_the_references(opcode, n):
    for fin in (True, False):
        assert pws.build_frame(opcode, _payload(n), fin=fin) == jws.build_frame(opcode, _payload(n), fin=fin)


@pytest.mark.parametrize("n", LENGTHS)
def test_masked_frames_equal_the_references(n, monkeypatch):
    """A fixed mask (``os.urandom`` replaced) makes client frames
    comparable: same header, same mask, same masked payload."""
    for mask in (b"\x00\x00\x00\x00", b"\x12\x34\x56\x78", b"\xff\x80\x01\x7f"):
        monkeypatch.setattr(os, "urandom", lambda k, m=mask: m[:k])
        port = pws.build_masked_frame(pws.OP_BINARY, _payload(n))
        assert port == jws.build_masked_frame(jws.OP_BINARY, _payload(n))
        head = 2 + (0 if n < 126 else 2 if n < 1 << 16 else 8)
        assert port[head:head + 4] == mask


@pytest.mark.parametrize("code", [1000, 1001, 1002, 1009, 1011, 4000])
def test_close_frames_equal_the_references(code):
    body = struct.pack("!H", code)
    assert pws.build_frame(pws.OP_CLOSE, body) == jws.build_frame(jws.OP_CLOSE, body)
    a, b = socket.socketpair()
    try:
        pws.WebSocket(a).close(code)
        peer = jws.WebSocket(b, client=True)
        with pytest.raises(jws.ConnectionClosed) as e:
            peer.receive()
        assert e.value.code == code
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("server_mod,client_mod", [(pws, jws), (jws, pws)], ids=["port-server", "jax-server"])
def test_codecs_interoperate_over_a_socket(server_mod, client_mod):
    """Each package's server side decodes the other's client frames, at
    every length tier, fragmented, with a ping answered inline."""
    a, b = socket.socketpair()
    try:
        server = server_mod.WebSocket(a)
        client = client_mod.WebSocket(b, client=True)
        for n in (5, 200, 70_000):
            client.send_bytes(_payload(n))
            assert server.receive() == ("binary", _payload(n))
        b.sendall(client_mod.build_masked_frame(client_mod.OP_TEXT, b"frag", fin=False))
        b.sendall(client_mod.build_masked_frame(client_mod.OP_PING, b"hb"))
        b.sendall(client_mod.build_masked_frame(client_mod.OP_CONT, b"mented"))
        assert server.receive() == ("text", b"fragmented")
        assert client._read_frame() == (client_mod.OP_PONG, True, b"hb")
        server.send_text("back")
        assert client.receive() == ("text", b"back")
    finally:
        a.close()
        b.close()


def test_unmasked_client_frame_rejected():
    a, b = socket.socketpair()
    try:
        server = pws.WebSocket(a)
        b.sendall(jws.build_frame(jws.OP_TEXT, b"unmasked"))
        with pytest.raises(pws.ConnectionClosed) as e:
            server.receive()
        assert e.value.code == 1002
    finally:
        a.close()
        b.close()


ECHO = '''
import @PKG@ as mtpu

app = mtpu.App("ws-echo-@NAME@")


@app.function()
@mtpu.websocket_endpoint()
def echo(ws, prefix: str = ">"):
    while True:
        kind, payload = ws.receive()
        if payload == b"quit":
            ws.send_text("bye")
            return
        ws.send_text(prefix + payload.decode())
'''


def _load(tmp_path, template: str, pkg: str, name: str):
    path = tmp_path / f"{name}_app.py"
    path.write_text(template.replace("@PKG@", pkg).replace("@NAME@", name))
    loader = load_module_from_path if pkg.endswith("_torch") else jload
    return loader(str(path))


@pytest.mark.parametrize("side", ["port-gateway", "jax-gateway"])
def test_gateway_serves_the_other_packages_client(tmp_path, side):
    pkg, gw_mod, conn_mod = (
        ("modal_examples_tpu_torch", pgateway, jws) if side == "port-gateway"
        else ("modal_examples_tpu", jgateway, pws)
    )
    mod = _load(tmp_path, ECHO, pkg, side.replace("-", "_"))
    with mod.app.run():
        gw = gw_mod.Gateway(mod.app).start()
        try:
            host, port = gw.httpd.server_address[:2]
            ws = conn_mod.connect(host, port, "/echo?prefix=%23")
            ws.send_text("one")
            assert ws.receive() == ("text", b"#one")
            ws._send_raw(conn_mod.build_masked_frame(conn_mod.OP_TEXT, b"t", fin=False))
            ws._send_raw(conn_mod.build_masked_frame(conn_mod.OP_PING, b"p"))
            ws._send_raw(conn_mod.build_masked_frame(conn_mod.OP_CONT, b"wo"))
            assert ws._read_frame() == (conn_mod.OP_PONG, True, b"p")
            assert ws.receive() == ("text", b"#two")
            ws.send_text("quit")
            assert ws.receive() == ("text", b"bye")
            with pytest.raises(conn_mod.ConnectionClosed) as e:
                ws.receive()  # the gateway closes after the handler returns
            assert e.value.code == 1000
        finally:
            gw.stop()


def test_plain_get_is_426(tmp_path):
    import urllib.error
    import urllib.request

    mod = _load(tmp_path, ECHO, "modal_examples_tpu_torch", "port_426")
    with mod.app.run():
        gw = pgateway.Gateway(mod.app).start()
        try:
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(f"{gw.base_url}/echo", timeout=10)
            assert e.value.code == 426 and "upgrade" in json.load(e.value)["error"]
        finally:
            gw.stop()


# -- streaming ASR through each gateway ------------------------------------------

ASR = '''
import numpy as np

import @PKG@ as mtpu
from @PKG@.serving.streaming_asr import StreamingTranscriber
from @PKG@.web.websocket import ConnectionClosed

app = mtpu.App("ws-asr-@NAME@")
#: (params, cfg), set by the caller: the handler runs in the gateway's process
MODEL = {}


@app.function()
@mtpu.websocket_endpoint()
def transcribe_ws(ws):
    t = StreamingTranscriber(MODEL["params"], MODEL["cfg"], bos_id=0, eos_id=1, window_s=2.0, hop_s=0.5,
                             max_tokens=8, decode_text=lambda toks: "".join(chr(97 + t % 26) for t in toks))
    try:
        while True:
            kind, payload = ws.receive()
            if kind == "text" and payload == b"end":
                ws.send_json({"type": "final", "text": t.flush().committed_text})
                return
            res = t.feed(np.frombuffer(payload, np.float32))
            if res is not None:
                ws.send_json({"type": "partial", "stable": res.stable_text, "pending": res.partial_text,
                              "committed": res.committed_text})
    except ConnectionClosed:
        pass
'''


def _asr_events(mod, gw_mod, conn_mod, chunks) -> list:
    """Every event of one stream: the chunks sent back to back, then "end"."""
    with mod.app.run():
        gw = gw_mod.Gateway(mod.app).start()
        try:
            host, port = gw.httpd.server_address[:2]
            ws = conn_mod.connect(host, port, "/transcribe_ws", read_timeout=60)
            for c in chunks:
                ws.send_bytes(c.tobytes())
            ws.send_text("end")
            events = []
            while not events or events[-1]["type"] != "final":
                events.append(json.loads(ws.receive()[1]))
            ws.close()
            return events
        finally:
            gw.stop()


def test_streaming_asr_events_equal_the_reference_gateways(tmp_path):
    cfg = jwhisper.WhisperConfig.test_tiny()
    rng = np.random.default_rng(10)
    np_params = jax.tree.map(
        lambda a: (np.asarray(a, np.float32) + rng.normal(0, 0.02, a.shape)).astype(np.float32),
        jwhisper.init_params(jax.random.PRNGKey(0), cfg),
    )
    tcfg = twhisper.WhisperConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    wave = taudio.synth_tone_audio([300.0, 1200.0], seconds=3.2).astype(np.float32)
    chunks = [wave[i:i + 4000] for i in range(0, len(wave), 4000)]  # 0.25 s each

    jmod = _load(tmp_path, ASR, "modal_examples_tpu", "jax_asr")
    jmod.MODEL.update(params=jax.tree.map(jnp.asarray, np_params), cfg=cfg)
    pmod = _load(tmp_path, ASR, "modal_examples_tpu_torch", "port_asr")
    pmod.MODEL.update(params=twhisper.params_from_jax(np_params, tcfg, device="cpu"), cfg=tcfg)

    ref = _asr_events(jmod, jgateway, jws, chunks)
    port = _asr_events(pmod, pgateway, pws, chunks)
    assert port == ref
    partials = [e for e in port if e["type"] == "partial"]
    assert len(partials) >= 4 and port[-1]["text"]
    for a, b in zip(partials, partials[1:]):  # committed text never retracts
        assert b["committed"].startswith(a["committed"])
    assert port[-1]["text"].startswith(partials[-1]["committed"])
