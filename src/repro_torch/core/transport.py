"""The port's own copy of the reference's wire: the serialized edge
between a prefill fleet and a decode fleet (``serving/disagg.py``).

* :class:`Transport` — the protocol: duplex message send/recv over a
  checksummed binary wire format, plus the ``link_bw`` row the
  scheduler prices splits with (``core/scheduler.schedule_split``), and
  ``make_edge``, which routes a compiled plan's cross-accelerator edges
  through the codec on a serializing transport (``serializes``).
* :data:`TRANSPORTS` / :func:`resolve_transport` — the registry:
  ``"inproc"`` (byte queues between two threads), ``"pipe"`` (OS pipes
  across fork/exec), ``"socket"`` (TCP localhost or LAN).
* :class:`RemotePrefill` — the wire unit: one request's committed TABM
  slab plus its prefilled paged-pool payload (the *written* blocks only,
  never a whole ``max_len`` lane) with the scalar admission metadata a
  decode fleet needs to admit it into its own pool.

Wire format (stdlib only, never pickle, so corruption yields a typed
:class:`TransportError`)::

    MAGIC "TBM1" | rid i64 | header_len u32 |
    header JSON | crc32(header) u32 |
    payload bytes (concatenated buffers; lengths in the header) |
    crc32(payload) u32

The request id sits in the fixed prefix, before anything that can be
corrupted: a frame whose payload fails its checksum still names its
request (``TransportError.rid``, ``recoverable=True``) and the stream
stays aligned.  A bad magic, a truncated read or a corrupt header is a
stream-level failure (``recoverable=False``).

Every buffer crosses as raw bytes with its dtype NAME and shape in the
header, so a frame this module encodes is byte-identical to the
reference's ``encode_frame`` of the same data, bfloat16 included
(``"bfloat16"``, two bytes an element), and frames cross between the two
packages in both directions.  ``encode_frame`` takes numpy arrays or CPU
tensors; ``decode_frame`` returns CPU tensors (bfloat16 read as its
16-bit pattern and viewed as ``torch.bfloat16``: neither side needs
``ml_dtypes``).

The reference's ``SubmeshPipe`` (a hand-off between submeshes of a mesh)
has no counterpart on one card.
"""
from __future__ import annotations

import json
import os
import queue
import socket as _socket
import struct
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


class TransportError(RuntimeError):
    """A wire-format or channel failure.

    ``rid`` is the owning request when the frame prefix survived;
    ``recoverable`` says whether the stream is still frame-aligned
    (payload checksum mismatch: the frame was consumed whole, keep
    reading) or dead (truncation, bad magic, corrupt header)."""

    def __init__(self, msg: str, *, rid: Optional[int] = None,
                 recoverable: bool = False):
        super().__init__(msg)
        self.rid = rid
        self.recoverable = recoverable


# ---------------------------------------------------------------------------
# wire codec
# ---------------------------------------------------------------------------

MAGIC = b"TBM1"
_PREFIX = struct.Struct("<4sqI")       # magic, rid, header_len
_CRC = struct.Struct("<I")

# wire dtype name <-> torch dtype (the names are numpy's, as the
# reference writes them)
_DTYPES: Dict[str, torch.dtype] = {
    "bool": torch.bool, "uint8": torch.uint8, "int8": torch.int8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float32": torch.float32, "float64": torch.float64,
}
_NAMES = {dt: name for name, dt in _DTYPES.items()}


def _crc(data) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def _wire_buffer(a) -> Tuple[str, List[int], memoryview]:
    """(dtype name, shape, raw bytes) of one numpy array or CPU tensor; a
    0-d one goes as shape [1], as ``np.ascontiguousarray`` makes it."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise TransportError(f"encode_frame takes CPU tensors, got one "
                                 f"on {a.device}")
        if a.dtype not in _NAMES:
            raise TransportError(f"no wire name for dtype {a.dtype}")
        flat = a.detach().contiguous().reshape(-1)
        raw = (flat.view(torch.uint8) if flat.numel()
               else torch.empty(0, dtype=torch.uint8))
        return (_NAMES[a.dtype], list(a.shape) or [1],
                memoryview(raw.numpy()))
    a = np.ascontiguousarray(a)
    return a.dtype.name, list(a.shape), memoryview(a.reshape(-1).view(
        np.uint8))


def encode_frame(kind: str, meta: Dict[str, Any],
                 arrays: Sequence[Any] = (), rid: int = -1) -> bytes:
    """One message as one frame: JSON header (kind + meta + per-buffer
    dtype/shape/length descriptors) followed by the raw buffer bytes,
    each section checksummed.  ``arrays`` are numpy arrays or CPU
    tensors."""
    bufs = [_wire_buffer(a) for a in arrays]
    header = json.dumps({
        "kind": kind, "meta": meta,
        "bufs": [{"dtype": name, "shape": shape, "len": len(raw)}
                 for name, shape, raw in bufs],
    }).encode()
    payload = b"".join(raw for _, _, raw in bufs)
    return b"".join([
        _PREFIX.pack(MAGIC, rid, len(header)),
        header, _CRC.pack(_crc(header)),
        payload, _CRC.pack(_crc(payload)),
    ])


def decode_frame(read: Callable[[int], bytes]
                 ) -> Tuple[str, Dict[str, Any], List[torch.Tensor], int]:
    """Parse one frame from a ``read(n) -> exactly-n-bytes`` callable
    (which raises :class:`TransportError` on truncation).  Returns
    ``(kind, meta, tensors, rid)``, the tensors on the CPU; raises
    :class:`TransportError` typed per the module docstring."""
    magic, rid, header_len = _PREFIX.unpack(read(_PREFIX.size))
    if magic != MAGIC:
        raise TransportError(f"bad frame magic {magic!r} (stream "
                             f"desynchronized or not a transport peer)")
    header = read(header_len)
    (want,) = _CRC.unpack(read(_CRC.size))
    if _crc(header) != want:
        # the header carries the buffer lengths: with it corrupt the
        # frame boundary is unknowable, so the stream is dead
        raise TransportError(
            f"corrupt frame header for rid {rid} (checksum mismatch)",
            rid=rid if rid >= 0 else None)
    try:
        h = json.loads(header)
        descs = h["bufs"]
        total = sum(int(d["len"]) for d in descs)
    except (ValueError, KeyError, TypeError) as e:
        raise TransportError(f"unparseable frame header for rid {rid}: "
                             f"{e}", rid=rid if rid >= 0 else None) from e
    payload = read(total)
    (want,) = _CRC.unpack(read(_CRC.size))
    if _crc(payload) != want:
        # the frame was consumed whole (the lengths were good), so the
        # stream stays aligned: fail only the owning request
        raise TransportError(
            f"corrupt frame payload for rid {rid} (checksum mismatch)",
            rid=rid if rid >= 0 else None, recoverable=True)
    view = memoryview(payload)
    tensors, off = [], 0
    for d in descs:
        n = int(d["len"])
        dt = _DTYPES.get(d["dtype"])
        if dt is None:
            raise TransportError(f"frame names unknown dtype "
                                 f"{d['dtype']!r}", rid=rid if rid >= 0
                                 else None, recoverable=True)
        # each buffer its own writable, aligned copy of its bytes
        t = (torch.frombuffer(bytearray(view[off:off + n]), dtype=dt)
             if n else torch.empty(0, dtype=dt))
        tensors.append(t.reshape(d["shape"]))
        off += n
    return h["kind"], h.get("meta", {}), tensors, rid


class BytesReader:
    """``read(n)`` over an in-memory frame, with the same truncation
    contract as the pipe and socket readers."""

    def __init__(self, data: bytes):
        self._view = memoryview(data)
        self._off = 0

    def read(self, n: int) -> bytes:
        if self._off + n > len(self._view):
            raise TransportError(
                f"truncated frame: wanted {n} bytes, "
                f"{len(self._view) - self._off} left")
        out = self._view[self._off:self._off + n].tobytes()
        self._off += n
        return out


# ---------------------------------------------------------------------------
# the wire unit
# ---------------------------------------------------------------------------

@dataclass
class RemotePrefill:
    """One prefilled request, ready for remote admission.

    ``kv`` holds, per cache group position, the flat leaf list of the
    prefill-written state: paged (attention) positions ship ``(L, nb,
    block_size, KV, hd)``, the first ``nb`` *written* blocks of the grant,
    and slot-state positions (Mamba-2, linear attention) the request's
    ``(L, 1, ...)`` row.  The leaves, the prompt and the slab are CPU
    tensors as ``PagedKVCache.export_blocks`` and :func:`decode_frame`
    give them, or numpy arrays (a frame the reference built); either
    encodes to the same bytes.  The tree structure is not serialized:
    both fleets run the same config, so the importer re-derives it from
    its own pool.

    ``slab`` is the committed TABM slab, trimmed to its token count:
    decode reads only the imported KV, but the slab rides along so the
    hand-off is self-contained."""

    rid: int
    prompt: Any                            # int32 prompt token ids
    first_token: int                       # picked from the prefill logits
    max_new_tokens: int
    blocks_granted: int                    # decode-side grant size
    paged: Tuple[bool, ...]                # per-position layout flags
    kv: List[List[Any]]                    # per-position flat leaves
    slot_class: Optional[str] = None
    slab: Optional[Any] = None             # committed TABM slab, trimmed
    prompt_len: int = 0

    def __post_init__(self):
        if not self.prompt_len:
            self.prompt_len = int(len(self.prompt))

    def kv_wire_bytes(self) -> int:
        """Bytes of paged KV crossing the wire: the quantity held against
        the whole-lane baseline (``PagedKVCache.slot_lane_bytes``)."""
        return sum(int(leaf.nbytes)
                   for pos, leaves in enumerate(self.kv) if self.paged[pos]
                   for leaf in leaves)

    def to_wire(self) -> Tuple[str, Dict[str, Any], List[Any]]:
        meta = {"rid": self.rid, "first_token": int(self.first_token),
                "max_new_tokens": int(self.max_new_tokens),
                "blocks_granted": int(self.blocks_granted),
                "slot_class": self.slot_class,
                "prompt_len": int(self.prompt_len),
                "paged": list(self.paged),
                "kv_layout": [len(leaves) for leaves in self.kv],
                "has_slab": self.slab is not None}
        arrays: List[Any] = [np.asarray(self.prompt, np.int32)]
        if self.slab is not None:
            arrays.append(self.slab)
        for leaves in self.kv:
            arrays.extend(leaves)
        return "prefill", meta, arrays

    @classmethod
    def from_wire(cls, meta: Dict[str, Any],
                  arrays: List[Any]) -> "RemotePrefill":
        try:
            it = iter(arrays)
            prompt = next(it)
            slab = next(it) if meta["has_slab"] else None
            kv = [[next(it) for _ in range(n)] for n in meta["kv_layout"]]
            return cls(rid=int(meta["rid"]), prompt=prompt,
                       first_token=int(meta["first_token"]),
                       max_new_tokens=int(meta["max_new_tokens"]),
                       blocks_granted=int(meta["blocks_granted"]),
                       paged=tuple(bool(p) for p in meta["paged"]),
                       kv=kv, slot_class=meta.get("slot_class"),
                       slab=slab, prompt_len=int(meta["prompt_len"]))
        except (KeyError, StopIteration, TypeError, ValueError) as e:
            raise TransportError(
                f"malformed prefill frame for rid {meta.get('rid')}: {e}",
                rid=meta.get("rid"), recoverable=True) from e


# ---------------------------------------------------------------------------
# the Transport protocol
# ---------------------------------------------------------------------------

class Transport:
    """Duplex typed-message channel between a prefill and a decode fleet.

    Subclasses implement the byte movement (``_send_bytes`` /
    ``_recv_exact``); the base class owns framing and the message API.
    ``link_bw`` is the modeled wire bandwidth the reference's split
    pricing reads; ``send_seconds`` the measured one's clock."""

    name: str = "base"
    #: modeled wire bandwidth (bytes/s)
    link_bw: float = 8e9
    #: plan edges bound to this transport cross the wire codec
    serializes: bool = False

    def __init__(self):
        self._send_lock = threading.Lock()
        self._recv_lock = threading.Lock()
        self.sent_frames = 0
        self.sent_bytes = 0
        self.send_seconds = 0.0

    # -- byte movement (subclass responsibility) ----------------------------
    def _send_bytes(self, data: bytes) -> None:
        raise NotImplementedError

    def _recv_exact(self, n: int) -> bytes:
        raise NotImplementedError

    def close(self) -> None:
        pass

    # -- message api --------------------------------------------------------
    def send(self, kind: str, meta: Optional[Dict[str, Any]] = None,
             arrays: Sequence[Any] = (), rid: int = -1) -> int:
        """Frame and send one message; returns the frame's wire bytes.
        Thread-safe (one lock per direction): frames from concurrent
        senders interleave whole, never torn."""
        return self.send_frame(encode_frame(kind, meta or {}, arrays,
                                            rid=rid))

    def send_frame(self, frame: bytes) -> int:
        """Send one encoded frame (:func:`encode_frame`), clocking the
        byte movement into ``send_seconds``; returns its bytes."""
        with self._send_lock:
            t0 = time.perf_counter()
            self._send_bytes(frame)
            self.send_seconds += time.perf_counter() - t0
            self.sent_frames += 1
            self.sent_bytes += len(frame)
        return len(frame)

    def measured_link_bw(self, min_bytes: int = 1 << 16
                         ) -> Optional[float]:
        """Observed wire bandwidth (bytes/s) over every frame sent so
        far, or None below ``min_bytes`` of evidence."""
        if self.sent_bytes < min_bytes or self.send_seconds <= 0.0:
            return None
        return self.sent_bytes / self.send_seconds

    def send_prefill(self, rp: RemotePrefill) -> int:
        kind, meta, arrays = rp.to_wire()
        return self.send(kind, meta, arrays, rid=rp.rid)

    def recv(self) -> Tuple[str, Dict[str, Any], List[torch.Tensor], int]:
        """Receive one message: ``(kind, meta, tensors, rid)``.  Raises
        :class:`TransportError` per the failure taxonomy; a
        ``recoverable`` error consumed its whole frame, so the caller may
        keep receiving."""
        with self._recv_lock:
            return decode_frame(self._recv_exact)

    # -- plan-edge routing --------------------------------------------------
    def make_edge(self, src_accel, dst_accel, backend) -> Callable:
        """The inbound-transfer factory for a plan bound to this
        transport: the backend's edge says where the value lands; on a
        serializing transport the value first round-trips through the
        wire codec, so the format is shown transparent to plan dataflow
        (logits bit-identical across transports)."""
        inner = backend.make_edge(src_accel, dst_accel)
        if not self.serializes:
            return inner
        return _codec_edge(inner)


def _codec_edge(inner: Callable) -> Callable:
    """Wrap a backend edge with an encode->decode pass through the codec
    messages use (a card tensor goes through the host, as it would on a
    real pipe or socket); ``inner`` puts the decoded tensor where the
    backend wants it."""
    def edge(v):
        _, _, (back,), _ = decode_frame(BytesReader(encode_frame(
            "edge", {}, [v.detach().cpu()])).read)
        return inner(back)
    return edge


# ---------------------------------------------------------------------------
# concrete transports
# ---------------------------------------------------------------------------

class InProcTransport(Transport):
    """Two fleets in one process: frames cross a pair of byte queues
    between threads.  Messages are still serialized: the wire format is
    exercised on every send."""

    name = "inproc"
    link_bw = 64e9

    def __init__(self):
        super().__init__()
        self._tx: "queue.Queue[Optional[bytes]]" = queue.Queue()
        self._rx: "queue.Queue[Optional[bytes]]" = self._tx  # loopback
        self._buf = b""
        self._closed = False

    @classmethod
    def pair(cls) -> Tuple["InProcTransport", "InProcTransport"]:
        """Cross-wired duplex pair: a.send -> b.recv and vice versa."""
        a, b = cls(), cls()
        a._rx, b._rx = b._tx, a._tx
        return a, b

    def _send_bytes(self, data: bytes) -> None:
        if self._closed:
            raise TransportError("send on a closed inproc transport")
        self._tx.put(bytes(data))

    def _recv_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            frame = self._rx.get()
            if frame is None:
                raise TransportError(
                    f"truncated stream: peer closed with {len(self._buf)} "
                    f"of {n} wanted bytes buffered")
            self._buf += frame
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def close(self) -> None:
        self._closed = True
        self._tx.put(None)              # wakes a peer blocked in recv


class PipeTransport(Transport):
    """Inter-process transport over OS pipes: the parent spawns the
    decode fleet as a subprocess and hands it the fd pair
    (``launch/serve_disagg.py --role decode --recv-fd N --send-fd M``)."""

    name = "pipe"
    link_bw = 2e9
    serializes = True

    def __init__(self, recv_fd: Optional[int], send_fd: Optional[int]):
        super().__init__()
        self._recv_fd = recv_fd
        self._send_fd = send_fd

    @classmethod
    def pair(cls) -> Tuple["PipeTransport", "PipeTransport"]:
        """Duplex pair over two pipes in one process (the subprocess case
        passes the raw fds through ``subprocess.Popen(pass_fds=...)``)."""
        a2b_r, a2b_w = os.pipe()
        b2a_r, b2a_w = os.pipe()
        return cls(b2a_r, a2b_w), cls(a2b_r, b2a_w)

    def _send_bytes(self, data: bytes) -> None:
        if self._send_fd is None:
            raise TransportError("pipe transport has no send fd")
        view = memoryview(data)
        while view:
            try:
                n = os.write(self._send_fd, view)
            except OSError as e:
                raise TransportError(f"pipe send failed: {e}") from e
            view = view[n:]

    def _recv_exact(self, n: int) -> bytes:
        if self._recv_fd is None:
            raise TransportError("pipe transport has no recv fd")
        chunks, got = [], 0
        while got < n:
            try:
                chunk = os.read(self._recv_fd, n - got)
            except OSError as e:
                raise TransportError(f"pipe recv failed: {e}") from e
            if not chunk:
                raise TransportError(
                    f"truncated stream: pipe closed with {got} of {n} "
                    f"wanted bytes read")
            chunks.append(chunk)
            got += len(chunk)
        return b"".join(chunks)

    def close(self) -> None:
        for fd in (self._send_fd, self._recv_fd):
            if fd is not None:
                try:
                    os.close(fd)
                except OSError:
                    pass
        self._send_fd = self._recv_fd = None


class SocketTransport(Transport):
    """TCP transport: the fleet boundary as a network hop, the same
    codec (the launcher connects over localhost).  The timeout bounds
    only the connect and accept: a connected socket blocks, since a
    decode fleet's first result may come later than any such bound."""

    name = "socket"
    link_bw = 1e9
    serializes = True

    def __init__(self, sock: "_socket.socket"):
        super().__init__()
        self._sock = sock
        sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)

    @classmethod
    def listen(cls, host: str = "127.0.0.1", port: int = 0
               ) -> Tuple["_socket.socket", int]:
        srv = _socket.socket()
        srv.setsockopt(_socket.SOL_SOCKET, _socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(1)
        return srv, srv.getsockname()[1]

    @classmethod
    def accept(cls, srv: "_socket.socket",
               timeout: Optional[float] = 60.0) -> "SocketTransport":
        srv.settimeout(timeout)
        conn, _ = srv.accept()
        conn.settimeout(None)
        return cls(conn)

    @classmethod
    def connect(cls, host: str, port: int,
                timeout: Optional[float] = 60.0) -> "SocketTransport":
        sock = _socket.create_connection((host, port), timeout=timeout)
        sock.settimeout(None)
        return cls(sock)

    def _send_bytes(self, data: bytes) -> None:
        try:
            self._sock.sendall(data)
        except OSError as e:
            raise TransportError(f"socket send failed: {e}") from e

    def _recv_exact(self, n: int) -> bytes:
        chunks, got = [], 0
        while got < n:
            try:
                chunk = self._sock.recv(n - got)
            except OSError as e:
                raise TransportError(f"socket recv failed: {e}") from e
            if not chunk:
                raise TransportError(
                    f"truncated stream: socket closed with {got} of {n} "
                    f"wanted bytes read")
            chunks.append(chunk)
            got += len(chunk)
        return b"".join(chunks)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

TRANSPORTS: Dict[str, type] = {
    "inproc": InProcTransport,
    "pipe": PipeTransport,
    "socket": SocketTransport,
}


def register_transport(cls: type) -> type:
    """Add a custom transport to the registry (a class, not an instance:
    transports are stateful connections, made per fleet pair)."""
    TRANSPORTS[cls.name] = cls
    return cls


def resolve_transport(spec) -> type:
    """Registry name or class -> transport class (connections are built
    by the caller via ``pair()`` / ``listen`` + ``connect``)."""
    if isinstance(spec, type) and issubclass(spec, Transport):
        return spec
    try:
        return TRANSPORTS[spec]
    except (KeyError, TypeError):
        raise TransportError(f"unknown transport {spec!r}; registered: "
                             f"{sorted(TRANSPORTS)}") from None
