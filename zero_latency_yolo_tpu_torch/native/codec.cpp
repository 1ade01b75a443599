// Native ZLTY wire-codec core — the per-packet hot path of the host tier.
//
// Rebuild of the reference's header-only C++ codec
// (reference: src/common/protocol.h). The Python runtime calls these via
// ctypes; each function is one C call per datagram instead of a chain of
// Python-level parses:
//
//   zl_crc16                   CRC-16/CCITT-FALSE (protocol.h:76-89)
//   zl_validate_packet         magic/version/length/CRC check + header out
//   zl_build_ack               serialize an ACK packet in place
//   zl_build_heartbeat         serialize a HEARTBEAT packet in place
//   zl_build_detection_result  serialize DETECTION_RESULT from a flat
//                              detection array (the per-frame send path)
//   zl_parse_frame_header      FRAME_DATA body fields + payload offset
//
// Wire layout notes (must match the reference byte-for-byte):
//   header: packed 22B {u32 magic, u8 ver, u8 type, u16 len, u32 seq,
//           u64 ts, u16 crc}; CRC over bytes [2..] with crc field zeroed
//   Detection: 40B with natural padding (4B pad before u64 timestamp)
//
// Build: zero_latency_yolo_tpu_torch/protocol/native.py compiles codec.cpp and
// udp.cpp with g++ -O3 -std=c++17 -fPIC -shared into build/native/ at first
// import (a copy of the JAX package's native sources).

#include <cstdint>
#include <cstring>

// The wire format is byte-frozen LITTLE-ENDIAN (protocol/packets.py '<'
// layouts); this codec serializes via host-endian memcpy, so a LE host is a
// hard precondition, enforced at compile time.
static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__,
              "ZLTY codec requires a little-endian host");

#include "codec.h"

extern "C" {

static const uint32_t ZL_MAGIC = 0x59544C5AU;  // "ZLTY"
static const uint8_t ZL_VERSION = 1;
static const int ZL_HEADER_SIZE = 22;
static const int ZL_CRC_OFFSET = 20;
static const int ZL_DETECTION_SIZE = 40;

// Table-driven CRC-16/CCITT-FALSE (poly 0x1021): byte-identical to the
// bit-at-a-time form but ~8x cheaper — the intake thread CRCs EVERY
// inbound payload (zl_udp_recv_batch2), where per-byte shift loops ate
// recvmmsg drain headroom at full load on small hosts.
static uint16_t g_crc_table[256];
static const bool g_crc_init = [] {
    for (int b = 0; b < 256; b++) {
        uint16_t crc = static_cast<uint16_t>(b << 8);
        for (int j = 0; j < 8; j++) {
            crc = (crc & 0x8000) ? static_cast<uint16_t>((crc << 1) ^ 0x1021)
                                 : static_cast<uint16_t>(crc << 1);
        }
        g_crc_table[b] = crc;
    }
    return true;
}();

static uint16_t crc16_update(uint16_t crc, const uint8_t* data, size_t size) {
    for (size_t i = 0; i < size; i++) {
        crc = static_cast<uint16_t>((crc << 8)
                                    ^ g_crc_table[(crc >> 8) ^ data[i]]);
    }
    return crc;
}

uint16_t zl_crc16(const uint8_t* data, size_t size) {
    return crc16_update(0xFFFF, data, size);
}

// ZlHeader lives in codec.h (shared with udp.cpp — see the header note).

// Returns 0 ok; 1 too small; 2 bad magic/version; 3 bad length; 4 bad CRC.
int zl_validate_packet(const uint8_t* data, size_t size, ZlHeader* out) {
    if (size < static_cast<size_t>(ZL_HEADER_SIZE)) return 1;
    uint32_t magic;
    std::memcpy(&magic, data, 4);
    if (magic != ZL_MAGIC || data[4] != ZL_VERSION) return 2;
    uint16_t length;
    std::memcpy(&length, data + 6, 2);
    if (static_cast<size_t>(ZL_HEADER_SIZE) + length != size) return 3;
    uint16_t wire_crc;
    std::memcpy(&wire_crc, data + ZL_CRC_OFFSET, 2);
    // CRC over [2..size) with the crc field zeroed: compute in three spans
    // to avoid copying the datagram.
    static const uint8_t zeros[2] = {0, 0};
    uint16_t crc = crc16_update(0xFFFF, data + 2, ZL_CRC_OFFSET - 2);
    crc = crc16_update(crc, zeros, 2);
    crc = crc16_update(crc, data + ZL_HEADER_SIZE, size - ZL_HEADER_SIZE);
    if (crc != wire_crc) return 4;
    if (out) {
        out->type = data[5];
        out->length = length;
        std::memcpy(&out->sequence, data + 8, 4);
        std::memcpy(&out->timestamp, data + 12, 8);
    }
    return 0;
}

static void zl_write_header(uint8_t* buf, uint8_t type, uint16_t body_len,
                            uint32_t seq, uint64_t ts) {
    std::memcpy(buf, &ZL_MAGIC, 4);
    buf[4] = ZL_VERSION;
    buf[5] = type;
    std::memcpy(buf + 6, &body_len, 2);
    std::memcpy(buf + 8, &seq, 4);
    std::memcpy(buf + 12, &ts, 8);
    std::memset(buf + ZL_CRC_OFFSET, 0, 2);
}

static void zl_finalize(uint8_t* buf, size_t total) {
    uint16_t crc = zl_crc16(buf + 2, total - 2);
    std::memcpy(buf + ZL_CRC_OFFSET, &crc, 2);
}

// out must hold >= 26 bytes. Returns packet size.
int zl_build_ack(uint8_t* out, uint32_t acked_seq, uint32_t seq, uint64_t ts) {
    zl_write_header(out, 8 /*ACK*/, 4, seq, ts);
    std::memcpy(out + ZL_HEADER_SIZE, &acked_seq, 4);
    zl_finalize(out, ZL_HEADER_SIZE + 4);
    return ZL_HEADER_SIZE + 4;
}

// out must hold >= 26 bytes. Returns packet size.
int zl_build_heartbeat(uint8_t* out, uint32_t ping, uint32_t seq, uint64_t ts) {
    zl_write_header(out, 0 /*HEARTBEAT*/, 4, seq, ts);
    std::memcpy(out + ZL_HEADER_SIZE, &ping, 4);
    zl_finalize(out, ZL_HEADER_SIZE + 4);
    return ZL_HEADER_SIZE + 4;
}

// Detections arrive as a flat f32 array [n][6]: x, y, w, h, conf, class_id,
// plus parallel u32 track_ids and one u64 det_timestamp for all entries
// (matching how the engine emits them). out must hold
// 22 + 14 + 40*n bytes. Returns packet size, or -1 if n > 1638 (u16 body).
int zl_build_detection_result(uint8_t* out, uint32_t frame_id,
                              uint64_t frame_ts, const float* dets,
                              const uint32_t* track_ids, uint64_t det_ts,
                              int n, uint32_t seq, uint64_t ts) {
    // body_len is a u16: 14 + 40*n must fit, so n caps at 1638 (not 65535 —
    // a larger n silently truncated body_len and emitted a corrupt packet).
    if (n < 0 || n > (0xFFFF - 14) / ZL_DETECTION_SIZE) return -1;
    uint16_t count = static_cast<uint16_t>(n);
    uint16_t body_len = static_cast<uint16_t>(14 + ZL_DETECTION_SIZE * n);
    zl_write_header(out, 4 /*DETECTION_RESULT*/, body_len, seq, ts);
    uint8_t* p = out + ZL_HEADER_SIZE;
    std::memcpy(p, &frame_id, 4);
    std::memcpy(p + 4, &frame_ts, 8);
    std::memcpy(p + 12, &count, 2);
    p += 14;
    for (int i = 0; i < n; i++) {
        const float* d = dets + i * 6;
        std::memcpy(p, d, 16);                        // box
        std::memcpy(p + 16, d + 4, 4);                // confidence
        // Saturating float->int: NaN/inf/out-of-range class values are
        // UB under a plain static_cast (and real data bugs shouldn't emit
        // unspecified bytes on the wire) — clamp to 0 instead.
        float cf = d[5];
        int32_t cls = (cf >= -2.0e9f && cf <= 2.0e9f)
                          ? static_cast<int32_t>(cf) : 0;
        std::memcpy(p + 20, &cls, 4);
        std::memcpy(p + 24, &track_ids[i], 4);
        std::memset(p + 28, 0, 4);                    // struct padding
        std::memcpy(p + 32, &det_ts, 8);
        p += ZL_DETECTION_SIZE;
    }
    zl_finalize(out, ZL_HEADER_SIZE + body_len);
    return ZL_HEADER_SIZE + body_len;
}

// FRAME_DATA from a pre-encoded payload: u32 frame_id, u64 frame_ts,
// u16 w, u16 h, u8 keyframe, payload (protocol.h:490-497 layout — the
// client-side encode twin of zl_parse_frame_header; a Python client at
// 60 FPS otherwise pays a pure-Python CRC over every payload).
// out must hold 22 + 17 + payload_len. Returns packet size, or -1 when
// the body exceeds the u16 length field.
int zl_build_frame_data(uint8_t* out, uint32_t frame_id, uint64_t frame_ts,
                        uint16_t w, uint16_t h, uint8_t keyframe,
                        const uint8_t* payload, int payload_len,
                        uint32_t seq, uint64_t ts) {
    const size_t body = 17 + static_cast<size_t>(payload_len);
    if (payload_len < 0 || body > 0xFFFF) return -1;
    zl_write_header(out, 3 /*FRAME_DATA*/, static_cast<uint16_t>(body),
                    seq, ts);
    uint8_t* b = out + ZL_HEADER_SIZE;
    std::memcpy(b, &frame_id, 4);
    std::memcpy(b + 4, &frame_ts, 8);
    std::memcpy(b + 12, &w, 2);
    std::memcpy(b + 14, &h, 2);
    b[16] = keyframe;
    if (payload_len > 0) std::memcpy(b + 17, payload, payload_len);
    zl_finalize(out, ZL_HEADER_SIZE + body);
    return static_cast<int>(ZL_HEADER_SIZE + body);
}

// Parse a validated FRAME_DATA packet's body. Returns 0 ok, 1 malformed.
int zl_parse_frame_header(const uint8_t* data, size_t size, ZlFrameHeader* out) {
    if (size < static_cast<size_t>(ZL_HEADER_SIZE + 17)) return 1;
    const uint8_t* b = data + ZL_HEADER_SIZE;
    std::memcpy(&out->frame_id, b, 4);
    std::memcpy(&out->timestamp, b + 4, 8);
    std::memcpy(&out->width, b + 12, 2);
    std::memcpy(&out->height, b + 14, 2);
    out->keyframe = b[16];
    if (out->width == 0 || out->height == 0) return 1;
    out->payload_offset = ZL_HEADER_SIZE + 17;
    out->payload_size = static_cast<uint32_t>(size) - out->payload_offset;
    return 0;
}

}  // extern "C"
