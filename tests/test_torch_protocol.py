"""The port's ZLTY codec: the cases of tests/test_protocol.py and
tests/test_native_codec.py on the port's modules, every packet type
byte-equal between the port's codec and the JAX package's (and round trips
parsed across them), the port's native codec against its Python codec, and
the native library built from the port's own sources into build/native/."""

import struct
from pathlib import Path

import numpy as np
import pytest

from zero_latency_yolo_tpu_torch.protocol import (
    HEADER_SIZE, MAGIC, AckPacket, ClientInfo, ClientInfoPacket,
    CommandPacket, ConfigUpdatePacket, Detection, DetectionResultPacket,
    ErrorPacket, FrameDataPacket, HeartbeatPacket, PacketType, ProtocolError,
    RoiHeader, ServerInfo, ServerInfoPacket, build_roi_header, crc16,
    parse_header, parse_packet, parse_roi_header,
)
from zero_latency_yolo_tpu_torch.protocol import native

REPO = Path(__file__).resolve().parent.parent
PORT_NATIVE = REPO / "zero_latency_yolo_tpu_torch" / "native"


def _golden(ptype: int, body: bytes, seq: int = 7, ts: int = 1234567890123) -> bytes:
    """Independent re-implementation of the C++ serializer for golden bytes."""
    hdr = struct.pack("<IBBHIQH", 0x59544C5A, 1, ptype, len(body), seq, ts, 0)
    pkt = bytearray(hdr + body)
    struct.pack_into("<H", pkt, 20, crc16(bytes(pkt[2:])))
    return bytes(pkt)


# --------------------------------------------- tests/test_protocol.py cases

def test_header_size_is_packed_22_bytes():
    assert HEADER_SIZE == 22


def test_heartbeat_golden_roundtrip():
    golden = _golden(0, struct.pack("<I", 42))
    assert HeartbeatPacket(ping=42, sequence=7,
                           timestamp=1234567890123).serialize() == golden
    back = parse_packet(golden)
    assert isinstance(back, HeartbeatPacket)
    assert (back.ping, back.sequence, back.timestamp) == (42, 7, 1234567890123)


def test_client_info_padded_struct_layout():
    info = ClientInfo(client_id=3, protocol_version=1,
                      screen_width=800, screen_height=600, game_id=1)
    body = info.pack()
    assert body == struct.pack("<IIHHB", 3, 1, 800, 600, 1) + b"\x00" * 3
    back = parse_packet(_golden(1, body))
    assert isinstance(back, ClientInfoPacket) and back.info == info


def test_server_info_padded_struct_layout():
    info = ServerInfo(server_id=9, protocol_version=1, model_version=1.5,
                      max_clients=10, max_fps=60, status=0)
    body = info.pack()
    assert len(body) == 20
    assert body[:12] == struct.pack("<IIf", 9, 1, 1.5)
    assert body[12] == 10 and body[13] == 0
    assert struct.unpack_from("<H", body, 14)[0] == 60
    assert body[16] == 0 and body[17:] == b"\x00" * 3
    back = parse_packet(_golden(2, body))
    assert isinstance(back, ServerInfoPacket) and back.info == info


def test_detection_struct_is_40_bytes_with_pad_before_timestamp():
    d = Detection(x=0.5, y=0.25, width=0.1, height=0.2, confidence=0.9,
                  class_id=2, track_id=77, timestamp=999)
    raw = d.pack()
    assert len(raw) == 40
    assert struct.unpack_from("<4f", raw, 0) == pytest.approx((0.5, 0.25, 0.1, 0.2))
    assert struct.unpack_from("<f", raw, 16)[0] == pytest.approx(0.9)
    assert struct.unpack_from("<i", raw, 20)[0] == 2
    assert struct.unpack_from("<I", raw, 24)[0] == 77
    assert raw[28:32] == b"\x00" * 4
    assert struct.unpack_from("<Q", raw, 32)[0] == 999
    back = Detection.unpack_from(raw)
    assert (back.class_id, back.track_id, back.timestamp) == (2, 77, 999)


def test_detection_is_the_engine_class():
    """The engine builds the same Detection the codec packs."""
    from zero_latency_yolo_tpu_torch.runtime import engine
    from zero_latency_yolo_tpu_torch.protocol import packets
    assert engine.Detection is packets.Detection is Detection


def test_detection_result_roundtrip():
    dets = [Detection(0.1 * i, 0.2, 0.05, 0.1, 0.8, i % 4, i, 1000 + i)
            for i in range(5)]
    raw = DetectionResultPacket(frame_id=1234, frame_timestamp=5678,
                                detections=dets, sequence=2,
                                timestamp=3).serialize()
    body = raw[HEADER_SIZE:]
    assert struct.unpack_from("<IQH", body) == (1234, 5678, 5)
    assert len(body) == 14 + 5 * 40
    back = parse_packet(raw)
    assert back.frame_id == 1234 and len(back.detections) == 5
    for a, b in zip(back.detections, dets):
        assert (a.class_id, a.track_id) == (b.class_id, b.track_id)
        assert abs(a.x - b.x) < 1e-6


def test_frame_data_roundtrip_and_nonstrict_payload():
    payload = bytes(range(256)) * 3
    back = parse_packet(FrameDataPacket(
        frame_id=5, frame_timestamp=100, width=16, height=16, keyframe=True,
        data=payload, sequence=9, timestamp=8).serialize())
    assert isinstance(back, FrameDataPacket)
    assert (back.width, back.height, back.keyframe) == (16, 16, True)
    assert back.data == payload


def test_command_error_ack_roundtrip():
    c = parse_packet(CommandPacket(command_type=5, command_data=b"xy").serialize())
    assert isinstance(c, CommandPacket) and (c.command_type, c.command_data) == (5, b"xy")
    e = parse_packet(ErrorPacket(error_code=2, message="full").serialize())
    assert isinstance(e, ErrorPacket) and (e.error_code, e.message) == (2, "full")
    a = parse_packet(AckPacket(acked_sequence=31337).serialize())
    assert isinstance(a, AckPacket) and a.acked_sequence == 31337
    assert a.TYPE == PacketType.ACK == 8


def test_corruption_detected():
    raw = bytearray(HeartbeatPacket(ping=1).serialize())
    raw[HEADER_SIZE] ^= 0xFF
    with pytest.raises(ProtocolError, match="checksum"):
        parse_packet(bytes(raw))


def test_bad_magic_and_truncation_rejected():
    raw = bytearray(HeartbeatPacket(ping=1).serialize())
    with pytest.raises(ProtocolError):
        parse_packet(bytes(raw[:10]))
    raw[0] ^= 0xFF
    with pytest.raises(ProtocolError, match="magic"):
        parse_packet(bytes(raw))


def test_length_mismatch_rejected():
    with pytest.raises(ProtocolError, match="length"):
        parse_packet(HeartbeatPacket(ping=1).serialize() + b"\x00")


def test_crc_is_ccitt_false():
    assert crc16(b"123456789") == 0x29B1


def test_header_parse():
    hdr = parse_header(HeartbeatPacket(ping=0, sequence=5,
                                       timestamp=6).serialize())
    assert hdr.magic == MAGIC and (hdr.sequence, hdr.timestamp) == (5, 6)
    assert hdr.type == PacketType.HEARTBEAT and hdr.length == 4


def test_roi_header_roundtrip():
    raw = build_roi_header(10, 20, 320, 240, 800)
    assert len(raw) == 16 and raw[:6] == b"ROIIMG"
    assert parse_roi_header(raw + b"jpegdata") == RoiHeader(
        x=10, y=20, width=320, height=240, full_width=800)
    assert parse_roi_header(b"\xff\xd8jpeg-soi" + bytes(20)) is None


def test_parser_fuzz_random_and_mutated():
    rng = np.random.default_rng(0)
    for n in (0, 1, 21, 22, 23, 64, 1500):
        for _ in range(200):
            try:
                parse_packet(rng.integers(0, 256, n, dtype=np.uint8).tobytes())
            except ProtocolError:
                pass
    for raw in (HeartbeatPacket(ping=7).serialize(),
                FrameDataPacket(frame_id=1, frame_timestamp=2, width=4,
                                height=4, data=b"x" * 48).serialize()):
        arr = np.frombuffer(raw, np.uint8).copy()
        for _ in range(500):
            mut = arr.copy()
            for _ in range(int(rng.integers(1, 4))):
                mut[int(rng.integers(len(mut)))] ^= 1 << int(rng.integers(8))
            try:
                parse_packet(mut.tobytes())
            except ProtocolError:
                pass


def test_config_update_packet_roundtrip():
    back = parse_packet(ConfigUpdatePacket(settings={
        "confidence_threshold": 0.6, "nms_threshold": 0.4}).serialize())
    assert isinstance(back, ConfigUpdatePacket)
    assert back.settings == {"confidence_threshold": 0.6, "nms_threshold": 0.4}
    with pytest.raises(ProtocolError, match="json"):
        parse_packet(_golden(7, b"\x05\x00{oops"))
    with pytest.raises(ProtocolError, match="object"):
        parse_packet(_golden(7, b"\x02\x00[]"))


def test_sequence_space_partitioned_from_native_acks():
    from zero_latency_yolo_tpu_torch.protocol.packets import next_sequence
    for _ in range(1000):
        assert 1 <= next_sequence() < 0x80000000


# ------------------------------------------ the JAX package's codec, byte for byte

def _packets(p, seed):
    """One packet of every type from package `p`'s protocol module, with
    fields drawn from a seed."""
    rng = np.random.default_rng(seed)
    u32 = lambda: int(rng.integers(1, 2 ** 31))  # noqa: E731
    f32 = lambda: float(np.float32(rng.random()))  # noqa: E731
    hdr = dict(sequence=u32(), timestamp=u32() * 1000)
    dets = [p.Detection(f32(), f32(), f32(), f32(), f32(),
                        int(rng.integers(0, 4)), u32(), u32())
            for _ in range(int(rng.integers(0, 33)))]
    payload = rng.integers(0, 256, int(rng.integers(0, 4000)),
                           dtype=np.uint8).tobytes()
    return {
        "heartbeat": p.HeartbeatPacket(ping=u32(), **hdr),
        "client_info": p.ClientInfoPacket(info=p.ClientInfo(
            client_id=u32(), screen_width=int(rng.integers(1, 4000)),
            screen_height=int(rng.integers(1, 4000)), game_id=1), **hdr),
        "server_info": p.ServerInfoPacket(info=p.ServerInfo(
            server_id=u32(), model_version=f32(), max_clients=10,
            max_fps=60, status=0), **hdr),
        "frame_data": p.FrameDataPacket(
            frame_id=u32(), frame_timestamp=u32(), width=160, height=120,
            keyframe=bool(rng.integers(0, 2)), data=payload, **hdr),
        "detection_result": p.DetectionResultPacket(
            frame_id=u32(), frame_timestamp=u32(), detections=dets, **hdr),
        "command": p.CommandPacket(command_type=int(rng.integers(0, 9)),
                                   command_data=payload[:64], **hdr),
        "config_update": p.ConfigUpdatePacket(
            settings={"confidence_threshold": f32(), "target_fps": 30}, **hdr),
        "error": p.ErrorPacket(error_code=int(rng.integers(0, 5)),
                               message="seeded %d" % seed, **hdr),
        "ack": p.AckPacket(acked_sequence=u32(), **hdr),
    }


PACKET_TYPES = ["heartbeat", "client_info", "server_info", "frame_data",
                "detection_result", "command", "config_update", "error", "ack"]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", PACKET_TYPES)
def test_packets_byte_equal_to_jax_codec(kind, seed):
    jp = pytest.importorskip("zero_latency_yolo_tpu.protocol")
    import zero_latency_yolo_tpu_torch.protocol as tp
    ours = _packets(tp, seed)[kind].serialize()
    theirs = _packets(jp, seed)[kind].serialize()
    assert ours == theirs
    # Round trips across the two codecs parse to the same fields.
    a, b = tp.parse_packet(theirs), jp.parse_packet(ours)
    assert a.TYPE == b.TYPE and vars(a).keys() == vars(b).keys()
    for k in vars(a):
        va, vb = getattr(a, k), getattr(b, k)
        if isinstance(va, list):
            assert [vars(x) for x in va] == [vars(x) for x in vb]
        elif hasattr(va, "__dataclass_fields__"):
            assert vars(va) == vars(vb)
        else:
            assert va == vb, k


def test_roi_header_byte_equal_to_jax():
    jp = pytest.importorskip("zero_latency_yolo_tpu.protocol")
    for args in ((0, 0, 1, 1, 1), (10, 20, 320, 240, 800),
                 (65535, 1, 2, 3, 65535)):
        assert build_roi_header(*args) == jp.build_roi_header(*args)


# -------------------------------------- tests/test_native_codec.py cases

needs_native = pytest.mark.skipif(not native.HAVE_NATIVE,
                                  reason="no C++ compiler on this host")


@needs_native
def test_native_library_built_from_the_port_sources():
    """The library is the one build() names for the port's own sources and
    flags, under build/native/, never in the source tree; a second build
    reuses it."""
    path = native.library_path()
    assert path.parent == REPO / "build" / "native"
    assert path.exists() and native.build() == path
    assert str(path) == native._LIB._name
    assert not list(PORT_NATIVE.glob("*.so"))
    assert native.CXX_FLAGS[:4] == ("-O3", "-Wall", "-std=c++17", "-fPIC")


@needs_native
def test_native_crc_matches_python():
    rng = np.random.default_rng(0)
    for n in (0, 1, 9, 100, 1500, 65000):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert native.crc16_native(data) == crc16(data)


@needs_native
def test_native_validate_accepts_and_rejects():
    pkt = bytearray(HeartbeatPacket(ping=7, sequence=42,
                                    timestamp=123456).serialize())
    assert native.validate_packet(bytes(pkt)) == (0, 4, 42, 123456)
    pkt[23] ^= 0xFF
    assert native.validate_packet(bytes(pkt)) is None
    assert native.validate_packet(bytes(pkt[:10])) is None
    pkt2 = bytearray(HeartbeatPacket(ping=7).serialize())
    pkt2[0] ^= 1
    assert native.validate_packet(bytes(pkt2)) is None


@needs_native
def test_native_ack_and_heartbeat_byte_identical():
    raw = native.build_ack(31337, 5, 999)
    assert raw == AckPacket(acked_sequence=31337, sequence=5,
                            timestamp=999).serialize()
    assert parse_packet(raw).acked_sequence == 31337
    assert native.build_heartbeat(77, 9, 1000) == HeartbeatPacket(
        ping=77, sequence=9, timestamp=1000).serialize()


@needs_native
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_detection_result_byte_identical(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 33))
    dets = rng.random((n, 6)).astype(np.float32)
    dets[:, 5] = rng.integers(0, 4, n)
    tids = rng.integers(1, 2 ** 31, n).astype(np.uint32)
    raw = native.build_detection_result(1234, 5678, dets, tids, 4242, 3, 777)
    py = DetectionResultPacket(
        frame_id=1234, frame_timestamp=5678, sequence=3, timestamp=777,
        detections=[Detection(*map(float, d[:5]), int(d[5]), int(t), 4242)
                    for d, t in zip(dets, tids)]).serialize()
    assert raw == py
    assert [d.track_id for d in parse_packet(raw).detections] == tids.tolist()


@needs_native
def test_native_frame_header_parse():
    payload = b"x" * 100
    pkt = FrameDataPacket(frame_id=9, frame_timestamp=100, width=10, height=20,
                          keyframe=True, data=payload).serialize()
    fid, ts, w, h, kf, off = native.parse_frame_header(pkt)
    assert (fid, ts, w, h, kf) == (9, 100, 10, 20, True)
    assert pkt[off:] == payload


@needs_native
def test_native_build_frame_data_byte_identity():
    payload = bytes(np.random.default_rng(0).integers(0, 256, 333,
                                                      dtype=np.uint8))
    want = FrameDataPacket(frame_id=7, frame_timestamp=123456789, width=800,
                           height=600, keyframe=True, data=payload,
                           sequence=42, timestamp=987654321).serialize()
    got = native.build_frame_data(7, 123456789, 800, 600, True, payload,
                                  42, 987654321)
    assert got == want and parse_packet(got).data == payload
    assert native.build_frame_data(1, 2, 4, 4, False, b"", 3, 4) == \
        FrameDataPacket(frame_id=1, frame_timestamp=2, width=4, height=4,
                        keyframe=False, data=b"", sequence=3,
                        timestamp=4).serialize()
