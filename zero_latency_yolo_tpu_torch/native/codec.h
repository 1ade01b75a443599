// Shared declarations between the codec and transport translation units.
//
// ZlHeader and the cross-TU prototypes used to be hand-duplicated in
// udp.cpp; mismatched struct definitions across C translation units are
// not diagnosed by the compiler OR the linker — a field added in one copy
// would silently misread header bytes at runtime. One header makes drift
// a compile error. The layout mirrors protocol/packets.py's parsed view
// of the 22-byte wire header (byte-frozen; golden tests in
// tests/test_protocol.py and byte-identity in tests/test_native_codec.py).
#ifndef ZL_CODEC_H
#define ZL_CODEC_H

#include <cstddef>
#include <cstdint>

struct ZlHeader {
    uint8_t type;
    uint16_t length;
    uint32_t sequence;
    uint64_t timestamp;
};

// Parsed FRAME_DATA body view (filled by zl_parse_frame_header).
struct ZlFrameHeader {
    uint32_t frame_id;
    uint64_t timestamp;
    uint16_t width;
    uint16_t height;
    uint8_t keyframe;
    uint32_t payload_offset;  // from packet start
    uint32_t payload_size;
};

// recvmmsg batch descriptors (v1: raw datagrams; v2: pre-validated with
// inline-ACK flags) and the sendmmsg burst descriptor. These cross the
// C/ctypes boundary (runtime/transport.py mirrors the layouts) AND the
// codec_test.cpp translation unit — hand-duplicated copies drift silently
// (neither compiler nor linker diagnoses mismatched struct definitions
// across TUs), so they live here like ZlHeader.
struct ZlPacketDesc {
    uint32_t offset;   // into the arena
    uint32_t length;
    uint32_t ip_be;    // sender IPv4, network byte order
    uint16_t port_be;  // sender port, network byte order
    uint16_t _pad;
};

struct ZlPacketDesc2 {
    uint32_t offset;     // into the arena
    uint32_t length;
    uint32_t ip_be;      // sender IPv4, network byte order
    uint16_t port_be;    // sender port, network byte order
    uint8_t flags;       // bit0: valid ZLTY frame; bit1: ACK already sent
    uint8_t type;        // header fields (valid frames only)
    uint32_t sequence;
    uint32_t _pad;
    uint64_t timestamp;
};

struct ZlSendDesc {
    uint32_t offset;
    uint32_t length;
    uint32_t ip_be;
    uint16_t port_be;
    uint16_t _pad;
};

// Returns 0 ok; 1 too small; 2 bad magic/version; 3 bad length; 4 bad CRC.
extern "C" int zl_validate_packet(const uint8_t* data, size_t size,
                                  ZlHeader* out);
extern "C" int zl_build_ack(uint8_t* out, uint32_t acked_seq, uint32_t seq,
                            uint64_t ts);

#endif  // ZL_CODEC_H
