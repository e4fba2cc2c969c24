"""The port's wire (``repro_torch/core/transport.py``) against the
reference's (``repro/core/transport.py``), on the CPU.

The codec and transport cases of ``tests/test_transport.py`` run on the
port's copy; then the two packages meet: arrays made from a numpy seed
encode to byte-identical frames in both (bfloat16 included, which the
port carries without ``ml_dtypes``), a frame of either decodes in the
other, and frames written by the reference's ``PipeTransport`` into an
OS pipe are read by the port's."""
import os
import struct
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import transport as R
from repro_torch.core.transport import (InProcTransport, MAGIC, PipeTransport,
                                        RemotePrefill, SocketTransport,
                                        TRANSPORTS, Transport, BytesReader,
                                        TransportError, decode_frame,
                                        encode_frame, register_transport,
                                        resolve_transport)

_PREFIX_SIZE = struct.calcsize("<4sqI")
DTYPES = {"float32": np.float32, "float16": np.float16, "int32": np.int32,
          "bfloat16": ml_dtypes.bfloat16}


def _decode(frame: bytes):
    return decode_frame(BytesReader(frame).read)


def _bits(x) -> bytes:
    """Raw bytes of a numpy array or CPU tensor."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous().reshape(-1)
        return x.view(torch.uint8).numpy().tobytes() if x.numel() else b""
    return np.ascontiguousarray(x).tobytes()


def _tensor(a: np.ndarray) -> torch.Tensor:
    """numpy (bf16 as ml_dtypes) -> CPU tensor of the same bits."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _arrays(dtype: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    dt = DTYPES[dtype]
    if dtype == "int32":
        return [rng.integers(-2 ** 31, 2 ** 31 - 1, s).astype(dt)
                for s in ((3, 5), (7,), (2, 1, 4))] + [np.array([], dt)]
    return [(rng.standard_normal(s) * 3).astype(dt)
            for s in ((3, 5), (7,), (2, 1, 4))] + [np.array([], dt)]


# ---------------------------------------------------------------------------
# codec (the reference's cases, on the port)
# ---------------------------------------------------------------------------

def test_codec_roundtrip_bit_exact():
    rng = np.random.default_rng(0)
    arrays = [
        rng.standard_normal((3, 5)).astype(np.float32),
        rng.integers(-9, 9, (7,)).astype(np.int32),
        rng.integers(0, 255, (2, 2, 2)).astype(np.uint8),
        np.array([], np.float32),
        rng.standard_normal((4, 3)).astype(ml_dtypes.bfloat16),
    ]
    meta = {"rid": 3, "nested": {"k": [1, 2]}, "s": "x"}
    kind, got_meta, got, rid = _decode(
        encode_frame("prefill", meta, arrays, rid=3))
    assert (kind, rid, got_meta) == ("prefill", 3, meta)
    assert len(got) == len(arrays)
    for a, b in zip(arrays, got):
        assert isinstance(b, torch.Tensor) and b.device.type == "cpu"
        assert tuple(a.shape) == tuple(b.shape)
        assert _bits(a) == _bits(b)
    assert got[-1].dtype == torch.bfloat16


def test_codec_bad_magic_is_fatal():
    frame = bytearray(encode_frame("x", {}, rid=1))
    assert frame[:4] == MAGIC
    frame[:4] = b"NOPE"
    with pytest.raises(TransportError) as ei:
        _decode(bytes(frame))
    assert not ei.value.recoverable


def test_codec_truncation_is_fatal():
    frame = encode_frame("x", {}, [np.arange(8, dtype=np.int64)], rid=1)
    with pytest.raises(TransportError) as ei:
        _decode(frame[:-10])
    assert not ei.value.recoverable


def test_codec_corrupt_header_is_fatal():
    frame = bytearray(encode_frame("x", {"a": 1}, rid=5))
    frame[_PREFIX_SIZE] ^= 0xFF           # first header byte
    with pytest.raises(TransportError) as ei:
        _decode(bytes(frame))
    assert not ei.value.recoverable and ei.value.rid == 5


def test_codec_corrupt_payload_fails_only_owner():
    """Payload corruption is recoverable: the frame was consumed whole,
    the rid survived in the prefix, and the next frame still decodes."""
    bad = bytearray(encode_frame(
        "prefill", {}, [np.arange(32, dtype=np.float64)], rid=7))
    header_len = struct.unpack_from("<4sqI", bytes(bad))[2]
    bad[_PREFIX_SIZE + header_len + 4 + 3] ^= 0xFF    # a payload byte
    ok = encode_frame("prefill", {"fine": True}, rid=8)
    reader = BytesReader(bytes(bad) + ok)
    with pytest.raises(TransportError) as ei:
        decode_frame(reader.read)
    assert ei.value.recoverable and ei.value.rid == 7
    kind, meta, _, rid = decode_frame(reader.read)
    assert (kind, rid, meta) == ("prefill", 8, {"fine": True})


def test_codec_takes_tensors_and_rejects_card_tensors():
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    assert encode_frame("x", {}, [t]) == encode_frame("x", {}, [t.numpy()])
    # a strided view goes as its contiguous bytes
    assert encode_frame("x", {}, [t.t()]) == \
        encode_frame("x", {}, [np.ascontiguousarray(t.numpy().T)])
    with pytest.raises(TransportError):
        encode_frame("x", {}, [torch.zeros(2, device="meta")])


# ---------------------------------------------------------------------------
# transports + registry
# ---------------------------------------------------------------------------

def test_inproc_pair_duplex_and_close():
    a, b = InProcTransport.pair()
    a.send("ping", {"n": 1}, [np.arange(3, dtype=np.int32)], rid=1)
    kind, meta, arrays, rid = b.recv()
    assert (kind, meta, rid) == ("ping", {"n": 1}, 1)
    assert torch.equal(arrays[0], torch.arange(3, dtype=torch.int32))
    b.send("pong", {}, rid=1)
    assert a.recv()[0] == "pong"
    assert a.sent_frames == 1 and a.sent_bytes > 0
    a.close()
    with pytest.raises(TransportError) as ei:
        b.recv()
    assert not ei.value.recoverable
    with pytest.raises(TransportError):
        a.send("late", {})


def test_pipe_pair_roundtrip_and_close():
    a, b = PipeTransport.pair()
    a.send("msg", {"x": 2}, [np.ones((2, 2), np.float32)], rid=4)
    kind, meta, arrays, rid = b.recv()
    assert (kind, meta["x"], rid) == ("msg", 2, 4)
    assert torch.equal(arrays[0], torch.ones(2, 2))
    a.close()
    with pytest.raises(TransportError) as ei:
        b.recv()
    assert not ei.value.recoverable
    a.close()                              # idempotent
    b.close()


def test_socket_roundtrip_over_localhost():
    srv, port = SocketTransport.listen()
    got = []
    t = threading.Thread(target=lambda: got.append(
        SocketTransport.accept(srv, timeout=30.0)))
    t.start()
    a = SocketTransport.connect("127.0.0.1", port, timeout=30.0)
    t.join(timeout=30.0)
    assert not t.is_alive()
    srv.close()
    b = got[0]
    big = np.arange(1 << 18, dtype=np.float32)      # crosses many segments
    a.send("kv", {"k": 1}, [big], rid=9)
    kind, meta, arrays, rid = b.recv()
    assert (kind, meta, rid) == ("kv", {"k": 1}, 9)
    assert _bits(arrays[0]) == big.tobytes()
    a.close()
    with pytest.raises(TransportError):
        b.recv()
    b.close()


def test_registry_and_resolve():
    assert set(TRANSPORTS) >= {"inproc", "pipe", "socket"}
    assert resolve_transport("socket") is SocketTransport
    assert resolve_transport(InProcTransport) is InProcTransport
    with pytest.raises(TransportError):
        resolve_transport("carrier-pigeon")

    class Loopback(InProcTransport):
        name = "loopback-test"
    try:
        assert register_transport(Loopback) is Loopback
        assert resolve_transport("loopback-test") is Loopback
    finally:
        TRANSPORTS.pop("loopback-test", None)
    # the modeled wire rows the reference's split pricing reads
    for name in ("inproc", "pipe", "socket"):
        assert resolve_transport(name).link_bw == \
            R.resolve_transport(name).link_bw


def test_transport_measures_its_own_wire():
    a, b = InProcTransport.pair()
    assert a.measured_link_bw() is None          # no bytes yet
    a.send("kv", {"x": 1}, [np.zeros((1 << 16,), np.uint8)])
    b.recv()
    assert a.sent_bytes >= 1 << 16 and a.send_seconds > 0.0
    assert a.measured_link_bw() == pytest.approx(
        a.sent_bytes / a.send_seconds)


def test_base_transport_moves_no_bytes():
    with pytest.raises(NotImplementedError):
        Transport().send("x", {})


# ---------------------------------------------------------------------------
# the wire unit
# ---------------------------------------------------------------------------

def test_remote_prefill_wire_roundtrip():
    rng = np.random.default_rng(1)
    rp = RemotePrefill(
        rid=11, prompt=np.arange(6, dtype=np.int32), first_token=42,
        max_new_tokens=5, blocks_granted=4, paged=(True, False),
        kv=[[_tensor(rng.standard_normal((2, 3, 8)).astype(
            ml_dtypes.bfloat16))] * 2,
            [_tensor(rng.standard_normal((2, 1, 4)).astype(np.float32))]],
        slot_class="full",
        slab=_tensor(rng.standard_normal((9,)).astype(np.float32)))
    kind, meta, arrays = rp.to_wire()
    k2, m2, a2, rid = _decode(encode_frame(kind, meta, arrays, rid=rp.rid))
    back = RemotePrefill.from_wire(m2, a2)
    assert (back.rid, back.first_token, back.max_new_tokens,
            back.blocks_granted, back.slot_class, back.prompt_len) == \
        (11, 42, 5, 4, "full", 6)
    assert back.paged == (True, False)
    assert _bits(back.prompt) == _bits(rp.prompt)
    assert _bits(back.slab) == _bits(rp.slab)
    for l1, l2 in zip([x for ls in rp.kv for x in ls],
                      [x for ls in back.kv for x in ls]):
        assert l1.dtype == l2.dtype and _bits(l1) == _bits(l2)
    # only paged positions count toward the wire-savings assertion
    assert rp.kv_wire_bytes() == 2 * rp.kv[0][0].nbytes
    assert back.kv_wire_bytes() == rp.kv_wire_bytes()
    # a frame missing its arrays is a malformed-but-recoverable prefill
    with pytest.raises(TransportError) as ei:
        RemotePrefill.from_wire(m2, a2[:1])
    assert ei.value.recoverable and ei.value.rid == 11


def test_remote_prefill_frames_are_the_references():
    """A RemotePrefill built by each package from the same arrays goes
    out as the same frame, and decodes in the other package."""
    rng = np.random.default_rng(3)
    prompt = np.arange(9, dtype=np.int32)
    kv = [[rng.standard_normal((2, 2, 4, 1, 8)).astype(ml_dtypes.bfloat16)
           for _ in range(2)]]
    slab = rng.standard_normal((5, 6)).astype(ml_dtypes.bfloat16)
    common = dict(rid=4, prompt=prompt, first_token=7, max_new_tokens=3,
                  blocks_granted=3, paged=(True,), slot_class="thumb")
    ref = R.RemotePrefill(kv=kv, slab=slab, **common)
    port = RemotePrefill(kv=[[_tensor(a) for a in kv[0]]],
                         slab=_tensor(slab), **common)
    want = R.encode_frame(*ref.to_wire(), rid=4)
    assert encode_frame(*port.to_wire(), rid=4) == want
    assert port.kv_wire_bytes() == ref.kv_wire_bytes()
    _, meta, arrays, _ = _decode(want)
    back = RemotePrefill.from_wire(meta, arrays)
    assert encode_frame(*back.to_wire(), rid=4) == want


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
def test_frames_byte_identical_to_the_reference(dtype):
    arrays = _arrays(dtype)
    meta = {"rid": 2, "dtype": dtype, "nested": [1, {"a": None}]}
    want = R.encode_frame("prefill", meta, arrays, rid=2)
    assert encode_frame("prefill", meta, arrays, rid=2) == want
    assert encode_frame("prefill", meta, [_tensor(a) for a in arrays],
                        rid=2) == want


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_reference_frame_decodes_in_the_port(dtype):
    arrays = _arrays(dtype, seed=1)
    frame = R.encode_frame("prefill", {"k": dtype}, arrays, rid=6)
    kind, meta, got, rid = _decode(frame)
    assert (kind, meta, rid) == ("prefill", {"k": dtype}, 6)
    want_dt = {"float32": torch.float32, "float16": torch.float16,
               "int32": torch.int32, "bfloat16": torch.bfloat16}[dtype]
    for a, t in zip(arrays, got):
        assert t.dtype == want_dt and tuple(t.shape) == a.shape
        assert _bits(t) == _bits(a)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_port_frame_decodes_in_the_reference(dtype):
    arrays = _arrays(dtype, seed=2)
    frame = encode_frame("result", {"k": dtype},
                         [_tensor(a) for a in arrays], rid=8)
    kind, meta, got, rid = R.decode_frame(R._BytesReader(frame).read)
    assert (kind, meta, rid) == ("result", {"k": dtype}, 8)
    for a, b in zip(arrays, got):
        assert b.dtype.name == dtype and b.shape == a.shape
        assert a.tobytes() == b.tobytes()


def test_reference_pipe_writes_the_port_reads():
    """Frames the reference's PipeTransport writes into an OS pipe are
    read by the port's PipeTransport on its read end, in order, a
    corrupt payload failing only its own rid; the reverse direction
    over a second pipe too."""
    r1, w1 = os.pipe()
    r2, w2 = os.pipe()
    ref = R.PipeTransport(r2, w1)
    port = PipeTransport(r1, w2)
    try:
        sent = {dt: _arrays(dt, seed=5) for dt in DTYPES}
        for i, (dt, arrays) in enumerate(sent.items()):
            ref.send("prefill", {"dt": dt}, arrays, rid=i)
        bad = bytearray(R.encode_frame("prefill", {}, [np.arange(
            16, dtype=np.float32)], rid=77))
        bad[-6] ^= 0xFF                    # a payload byte
        ref._send_bytes(bytes(bad))
        ref.send("done", {})
        for i, (dt, arrays) in enumerate(sent.items()):
            kind, meta, got, rid = port.recv()
            assert (kind, meta, rid) == ("prefill", {"dt": dt}, i)
            assert [_bits(t) for t in got] == [_bits(a) for a in arrays]
        with pytest.raises(TransportError) as ei:
            port.recv()
        assert ei.value.recoverable and ei.value.rid == 77
        assert port.recv()[0] == "done"
        port.send("result", {"rid": 3}, [torch.tensor([5, 6, 7],
                                                      dtype=torch.int32)],
                  rid=3)
        kind, meta, got, rid = ref.recv()
        assert (kind, rid) == ("result", 3)
        np.testing.assert_array_equal(got[0], np.array([5, 6, 7], np.int32))
    finally:
        ref.close()
        port.close()
