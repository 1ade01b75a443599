"""ZLTY packet codec (pure Python, C-speed CRC via binascii).

Byte layout matches the reference exactly:

Header (packed, little-endian, 22 bytes — reference src/common/protocol.h:37-73;
note the reference's PROTOCOL_HEADER_SIZE constant of 16 is wrong, the packed
struct it actually memcpys onto the wire is 22 bytes):

    u32 magic      "ZLTY" = 0x59544C5A
    u8  version    1
    u8  type       PacketType
    u16 length     body length
    u32 sequence
    u64 timestamp  (ms since epoch)
    u16 checksum   CRC-16/CCITT-FALSE

Checksum quirk reproduced from the reference (src/common/protocol.h:182-192):
the CRC is computed over packet bytes [2:] (i.e. skipping the *first two
bytes of the magic*, because the C++ skips `sizeof(checksum)` bytes from the
start) with the checksum field itself zeroed.

Struct bodies are raw memcpys of naturally-aligned C structs
(src/common/types.h:20-56):

    ClientInfo  16B: u32 client_id, u32 protocol_version, u16 w, u16 h,
                     u8 game_id, 3B pad
    ServerInfo  20B: u32 server_id, u32 protocol_version, f32 model_version,
                     u8 max_clients, 1B pad, u16 max_fps, u8 status, 3B pad
    Detection   40B: f32 x,y,w,h (center-format, normalized), f32 confidence,
                     i32 class_id, u32 track_id, 4B pad, u64 timestamp

PacketType::ACK is used by the reference transport but missing from its enum
(src/common/protocol.h:784-816 vs src/common/types.h:73-82); we assign it 8.
"""

from __future__ import annotations

import binascii
import itertools
import json
import struct
import time
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Dict, List, Optional, Tuple

MAGIC = 0x59544C5A
VERSION = 1
MAX_PACKET_SIZE = 65536
HEADER_SIZE = 22

_HEADER = struct.Struct("<IBBHIQH")
_CLIENT_INFO = struct.Struct("<IIHHB3x")
_SERVER_INFO = struct.Struct("<IIfBxHB3x")
_DETECTION = struct.Struct("<4ffiI4xQ")
_FRAME_HDR = struct.Struct("<IQHHB")
_RESULT_HDR = struct.Struct("<IQH")
_U32 = struct.Struct("<I")
_CMD_HDR = struct.Struct("<BH")
_CFG_HDR = struct.Struct("<H")

DETECTION_SIZE = _DETECTION.size  # 40
assert DETECTION_SIZE == 40
assert _CLIENT_INFO.size == 16
assert _SERVER_INFO.size == 20


class PacketType(IntEnum):
    HEARTBEAT = 0
    CLIENT_INFO = 1
    SERVER_INFO = 2
    FRAME_DATA = 3
    DETECTION_RESULT = 4
    ERROR = 5
    COMMAND = 6
    CONFIG_UPDATE = 7
    ACK = 8  # missing from the reference enum; see module docstring


class ErrorCode(IntEnum):
    NONE = 0
    INVALID_PROTOCOL = 1
    SERVER_FULL = 2
    AUTHENTICATION_FAILED = 3
    TIMEOUT = 4
    INVALID_REQUEST = 5
    SERVER_ERROR = 6


class CommandType(IntEnum):
    NONE = 0
    START_STREAM = 1
    STOP_STREAM = 2
    PAUSE_STREAM = 3
    RESUME_STREAM = 4
    REQUEST_KEYFRAME = 5
    SET_CONFIG = 6
    GET_CONFIG = 7
    PING = 8
    DISCONNECT = 9


class ProtocolError(ValueError):
    pass

def _check_u16_len(n: int, what: str) -> int:
    """Typed guard for inner u16 length fields (review r5): an oversized
    command body/settings blob/error message must raise ProtocolError —
    the module's documented failure type — not an opaque struct.error
    from inside serialize()."""
    if n > 0xFFFF:
        raise ProtocolError(
            f"{what} length {n} exceeds the u16 wire limit (65535)")
    return n


def crc16(data: bytes) -> int:
    """CRC-16/CCITT-FALSE (poly 0x1021, init 0xFFFF) — reference protocol.h:76-89."""
    return binascii.crc_hqx(data, 0xFFFF)


def now_ms() -> int:
    return int(time.time() * 1000)


_seq_iter = itertools.count(1)


def next_sequence() -> int:
    """Monotonic sequence numbers in [1, 2^31) (reference protocol.h:28-34).
    itertools.count.__next__ is atomic under the GIL, so concurrent senders
    (event loop + completion thread) never mint duplicates. The top half of
    the u32 space [2^31, 2^32) is reserved for the native transport's inline
    ACK sequences (native/udp.cpp) so the two spaces never collide."""
    return (next(_seq_iter) - 1) % 0x7FFFFFFF + 1


@dataclass
class PacketHeader:
    type: int
    length: int = 0
    sequence: int = 0
    timestamp: int = 0
    checksum: int = 0
    magic: int = MAGIC
    version: int = VERSION


def parse_header(data: bytes) -> PacketHeader:
    if len(data) < HEADER_SIZE:
        raise ProtocolError(f"packet too small: {len(data)} < {HEADER_SIZE}")
    magic, version, ptype, length, seq, ts, csum = _HEADER.unpack_from(data)
    if magic != MAGIC or version != VERSION:
        raise ProtocolError("invalid packet magic or version")
    return PacketHeader(type=ptype, length=length, sequence=seq,
                        timestamp=ts, checksum=csum, magic=magic, version=version)


def _frame_packet(ptype: int, body: bytes, sequence: int, timestamp: int) -> bytes:
    if len(body) > 0xFFFF:
        # u16 length field: oversized bodies must fail with a typed error
        # (raw struct.error from deep inside serialize() is opaque; e.g. a
        # raw RGB frame beyond ~147x147 px can never fit one datagram —
        # send JPEG keyframes instead).
        raise ProtocolError(
            f"packet body {len(body)} exceeds the u16 wire limit (65535)")
    buf = bytearray(HEADER_SIZE + len(body))
    _HEADER.pack_into(buf, 0, MAGIC, VERSION, ptype, len(body), sequence, timestamp, 0)
    buf[HEADER_SIZE:] = body
    # CRC over bytes [2:] with checksum zeroed, then patched at offset 20.
    csum = crc16(bytes(buf[2:]))
    struct.pack_into("<H", buf, 20, csum)
    return bytes(buf)


def _check_and_strip(data: bytes, expected_type: Optional[int] = None) -> Tuple[PacketHeader, bytes]:
    hdr = parse_header(data)
    if HEADER_SIZE + hdr.length != len(data):
        raise ProtocolError(
            f"invalid packet length: expected {HEADER_SIZE + hdr.length}, got {len(data)}")
    if expected_type is not None and hdr.type != expected_type:
        raise ProtocolError(f"invalid packet type: expected {expected_type}, got {hdr.type}")
    tmp = bytearray(data)
    struct.pack_into("<H", tmp, 20, 0)
    if crc16(bytes(tmp[2:])) != hdr.checksum:
        raise ProtocolError("invalid packet checksum")
    return hdr, data[HEADER_SIZE:]


@dataclass
class Detection:
    """One detection result (reference src/common/types.h:20-26).

    Box is center-format (x, y = center) normalized to [0, 1] of the *source
    frame* dimensions, mirroring the reference postprocess
    (src/inference/onnx_engine.cpp:802-805).
    """
    x: float = 0.0
    y: float = 0.0
    width: float = 0.0
    height: float = 0.0
    confidence: float = 0.0
    class_id: int = 0
    track_id: int = 0
    timestamp: int = 0

    def pack(self) -> bytes:
        return _DETECTION.pack(self.x, self.y, self.width, self.height,
                               self.confidence, self.class_id, self.track_id,
                               self.timestamp)

    @classmethod
    def unpack_from(cls, data: bytes, offset: int = 0) -> "Detection":
        x, y, w, h, conf, cid, tid, ts = _DETECTION.unpack_from(data, offset)
        return cls(x, y, w, h, conf, cid, tid, ts)


@dataclass
class ClientInfo:
    client_id: int = 0
    protocol_version: int = VERSION
    screen_width: int = 0
    screen_height: int = 0
    game_id: int = 0

    def pack(self) -> bytes:
        return _CLIENT_INFO.pack(self.client_id, self.protocol_version,
                                 self.screen_width, self.screen_height, self.game_id)

    @classmethod
    def unpack(cls, data: bytes) -> "ClientInfo":
        return cls(*_CLIENT_INFO.unpack(data))


@dataclass
class ServerInfo:
    server_id: int = 0
    protocol_version: int = VERSION
    model_version: float = 1.0
    max_clients: int = 10
    max_fps: int = 60
    status: int = 0

    def pack(self) -> bytes:
        return _SERVER_INFO.pack(self.server_id, self.protocol_version,
                                 self.model_version, self.max_clients,
                                 self.max_fps, self.status)

    @classmethod
    def unpack(cls, data: bytes) -> "ServerInfo":
        return cls(*_SERVER_INFO.unpack(data))


class _Packet:
    TYPE: int = -1

    def __init__(self, sequence: int = 0, timestamp: int = 0):
        self.sequence = sequence or next_sequence()
        self.timestamp = timestamp or now_ms()

    def body(self) -> bytes:
        raise NotImplementedError

    def serialize(self) -> bytes:
        return _frame_packet(self.TYPE, self.body(), self.sequence, self.timestamp)

    @classmethod
    def deserialize(cls, data: bytes) -> "_Packet":
        hdr, body = _check_and_strip(data, cls.TYPE)
        pkt = cls._from_body(body)
        pkt.sequence = hdr.sequence
        pkt.timestamp = hdr.timestamp
        return pkt

    @classmethod
    def _from_body(cls, body: bytes) -> "_Packet":
        raise NotImplementedError


class HeartbeatPacket(_Packet):
    TYPE = PacketType.HEARTBEAT

    def __init__(self, ping: int = 0, **kw):
        super().__init__(**kw)
        self.ping = ping

    def body(self) -> bytes:
        return _U32.pack(self.ping)

    @classmethod
    def _from_body(cls, body: bytes) -> "HeartbeatPacket":
        if len(body) != 4:
            raise ProtocolError("invalid heartbeat body length")
        return cls(ping=_U32.unpack(body)[0], sequence=1, timestamp=1)


class AckPacket(_Packet):
    TYPE = PacketType.ACK

    def __init__(self, acked_sequence: int = 0, **kw):
        super().__init__(**kw)
        self.acked_sequence = acked_sequence

    def body(self) -> bytes:
        return _U32.pack(self.acked_sequence)

    @classmethod
    def _from_body(cls, body: bytes) -> "AckPacket":
        if len(body) != 4:
            raise ProtocolError("invalid ACK body length")
        return cls(acked_sequence=_U32.unpack(body)[0], sequence=1, timestamp=1)


class ClientInfoPacket(_Packet):
    TYPE = PacketType.CLIENT_INFO

    def __init__(self, info: Optional[ClientInfo] = None, **kw):
        super().__init__(**kw)
        self.info = info or ClientInfo()

    def body(self) -> bytes:
        return self.info.pack()

    @classmethod
    def _from_body(cls, body: bytes) -> "ClientInfoPacket":
        if len(body) != _CLIENT_INFO.size:
            raise ProtocolError("invalid client info body length")
        return cls(info=ClientInfo.unpack(body), sequence=1, timestamp=1)


class ServerInfoPacket(_Packet):
    TYPE = PacketType.SERVER_INFO

    def __init__(self, info: Optional[ServerInfo] = None, **kw):
        super().__init__(**kw)
        self.info = info or ServerInfo()

    def body(self) -> bytes:
        return self.info.pack()

    @classmethod
    def _from_body(cls, body: bytes) -> "ServerInfoPacket":
        if len(body) != _SERVER_INFO.size:
            raise ProtocolError("invalid server info body length")
        return cls(info=ServerInfo.unpack(body), sequence=1, timestamp=1)


class FrameDataPacket(_Packet):
    """FRAME_DATA: u32 frame_id, u64 timestamp, u16 w, u16 h, u8 keyframe, payload.

    Size check is deliberately non-strict: payload may be raw w*h*3 RGB, a
    JPEG keyframe, or a ROIIMG-headed region update
    (reference src/common/protocol.h:490-497).
    """
    TYPE = PacketType.FRAME_DATA

    def __init__(self, frame_id: int = 0, frame_timestamp: int = 0,
                 width: int = 0, height: int = 0, keyframe: bool = False,
                 data: bytes = b"", **kw):
        super().__init__(**kw)
        self.frame_id = frame_id
        self.frame_timestamp = frame_timestamp
        self.width = width
        self.height = height
        self.keyframe = keyframe
        self.data = data

    def body(self) -> bytes:
        return _FRAME_HDR.pack(self.frame_id, self.frame_timestamp,
                               self.width, self.height,
                               1 if self.keyframe else 0) + self.data

    @classmethod
    def _from_body(cls, body: bytes) -> "FrameDataPacket":
        if len(body) < _FRAME_HDR.size:
            raise ProtocolError("invalid frame data body length")
        fid, fts, w, h, kf = _FRAME_HDR.unpack_from(body)
        if w == 0 or h == 0:
            raise ProtocolError(f"invalid frame dimensions: {w}x{h}")
        return cls(frame_id=fid, frame_timestamp=fts, width=w, height=h,
                   keyframe=(kf != 0), data=body[_FRAME_HDR.size:],
                   sequence=1, timestamp=1)


class DetectionResultPacket(_Packet):
    """DETECTION_RESULT: u32 frame_id, u64 timestamp, u16 count, count×Detection(40B)."""
    TYPE = PacketType.DETECTION_RESULT

    def __init__(self, frame_id: int = 0, frame_timestamp: int = 0,
                 detections: Optional[List[Detection]] = None, **kw):
        super().__init__(**kw)
        self.frame_id = frame_id
        self.frame_timestamp = frame_timestamp
        self.detections = detections if detections is not None else []

    def body(self) -> bytes:
        parts = [_RESULT_HDR.pack(self.frame_id, self.frame_timestamp,
                                  len(self.detections))]
        parts.extend(d.pack() for d in self.detections)
        return b"".join(parts)

    @classmethod
    def _from_body(cls, body: bytes) -> "DetectionResultPacket":
        if len(body) < _RESULT_HDR.size:
            raise ProtocolError("invalid detection result body length")
        fid, fts, count = _RESULT_HDR.unpack_from(body)
        offset = _RESULT_HDR.size
        if offset + count * DETECTION_SIZE > len(body):
            raise ProtocolError("invalid detection count")
        dets = [Detection.unpack_from(body, offset + i * DETECTION_SIZE)
                for i in range(count)]
        return cls(frame_id=fid, frame_timestamp=fts, detections=dets,
                   sequence=1, timestamp=1)


class CommandPacket(_Packet):
    TYPE = PacketType.COMMAND

    def __init__(self, command_type: int = CommandType.NONE,
                 command_data: bytes = b"", **kw):
        super().__init__(**kw)
        self.command_type = command_type
        self.command_data = command_data

    def body(self) -> bytes:
        return _CMD_HDR.pack(
            self.command_type,
            _check_u16_len(len(self.command_data), "command_data")
        ) + self.command_data

    @classmethod
    def _from_body(cls, body: bytes) -> "CommandPacket":
        if len(body) < _CMD_HDR.size:
            raise ProtocolError("invalid command body length")
        ctype, dlen = _CMD_HDR.unpack_from(body)
        if _CMD_HDR.size + dlen > len(body):
            raise ProtocolError("invalid command data length")
        return cls(command_type=ctype,
                   command_data=body[_CMD_HDR.size:_CMD_HDR.size + dlen],
                   sequence=1, timestamp=1)


class ConfigUpdatePacket(_Packet):
    """CONFIG_UPDATE (type 7): u16 len + UTF-8 JSON settings.

    The reference declared the enum value (types.h:81) but defined no body
    and no handler — a CRC-valid type-7 packet was effectively invalid
    traffic. Here it carries a JSON object of runtime settings; the server
    applies the recognized keys (confidence_threshold, nms_threshold) live —
    thresholds are traced scalars, so updates cost zero recompiles."""
    TYPE = PacketType.CONFIG_UPDATE

    def __init__(self, settings: Optional[Dict] = None, **kw):
        super().__init__(**kw)
        self.settings: Dict = settings or {}

    def body(self) -> bytes:
        blob = json.dumps(self.settings).encode()
        return _CFG_HDR.pack(
            _check_u16_len(len(blob), "settings JSON")) + blob

    @classmethod
    def _from_body(cls, body: bytes) -> "ConfigUpdatePacket":
        if len(body) < _CFG_HDR.size:
            raise ProtocolError("invalid config update body length")
        (dlen,) = _CFG_HDR.unpack_from(body)
        if _CFG_HDR.size + dlen > len(body):
            raise ProtocolError("invalid config update data length")
        try:
            settings = json.loads(body[_CFG_HDR.size:_CFG_HDR.size + dlen]
                                  or b"{}")
        except ValueError as e:
            raise ProtocolError(f"invalid config update json: {e}") from None
        if not isinstance(settings, dict):
            raise ProtocolError("config update must be a JSON object")
        return cls(settings=settings, sequence=1, timestamp=1)


class ErrorPacket(_Packet):
    TYPE = PacketType.ERROR

    def __init__(self, error_code: int = ErrorCode.NONE, message: str = "", **kw):
        super().__init__(**kw)
        self.error_code = error_code
        self.message = message

    def body(self) -> bytes:
        msg = self.message.encode("utf-8")
        return _CMD_HDR.pack(
            self.error_code,
            _check_u16_len(len(msg), "error message")) + msg

    @classmethod
    def _from_body(cls, body: bytes) -> "ErrorPacket":
        if len(body) < _CMD_HDR.size:
            raise ProtocolError("invalid error body length")
        code, mlen = _CMD_HDR.unpack_from(body)
        if _CMD_HDR.size + mlen > len(body):
            raise ProtocolError("invalid error message length")
        return cls(error_code=code,
                   message=body[_CMD_HDR.size:_CMD_HDR.size + mlen].decode("utf-8", "replace"),
                   sequence=1, timestamp=1)


_PACKET_CLASSES = {
    PacketType.HEARTBEAT: HeartbeatPacket,
    PacketType.CLIENT_INFO: ClientInfoPacket,
    PacketType.SERVER_INFO: ServerInfoPacket,
    PacketType.FRAME_DATA: FrameDataPacket,
    PacketType.DETECTION_RESULT: DetectionResultPacket,
    PacketType.COMMAND: CommandPacket,
    PacketType.CONFIG_UPDATE: ConfigUpdatePacket,
    PacketType.ERROR: ErrorPacket,
    PacketType.ACK: AckPacket,
}


def parse_packet(data: bytes) -> _Packet:
    """Parse a datagram into a typed packet (reference PacketFactory,
    src/common/protocol.h:819-937). Raises ProtocolError on any invalidity."""
    hdr = parse_header(data)
    cls = _PACKET_CLASSES.get(hdr.type)
    if cls is None:
        raise ProtocolError(f"unknown packet type: {hdr.type}")
    return cls.deserialize(data)
