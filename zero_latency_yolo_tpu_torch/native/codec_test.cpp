// Native codec self-test + fuzz harness for the port's codec.cpp and udp.cpp,
// built with ASan + UBSan by `make test-native-torch` from the repo root
// (and by tests/test_torch_native.py where g++ accepts the sanitizers).
// The checks and the fuzz of the JAX package's native/codec_test.cpp, plus
// what the port's udp.cpp adds: the granted buffer sizes (zl_udp_buffers)
// and the socket's drop count (zl_udp_rxq_ovfl, SO_RXQ_OVFL).
//
//   codec_test            round-trip + known-answer checks
//   codec_test fuzz N     N random mutations of valid packets through
//                         zl_validate_packet / zl_parse_frame_header —
//                         must never crash or overread (ASan enforces)

#include <arpa/inet.h>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <netinet/in.h>
#include <random>
#include <sys/socket.h>
#include <unistd.h>
#include <vector>

extern "C" {
uint16_t zl_crc16(const uint8_t*, size_t);
#include "codec.h"  // ZlHeader + zl_validate_packet (one definition)
int zl_build_ack(uint8_t*, uint32_t, uint32_t, uint64_t);
int zl_build_heartbeat(uint8_t*, uint32_t, uint32_t, uint64_t);
int zl_build_detection_result(uint8_t*, uint32_t, uint64_t, const float*,
                              const uint32_t*, uint64_t, int, uint32_t, uint64_t);
int zl_parse_frame_header(const uint8_t*, size_t, ZlFrameHeader*);
// udp.cpp (linked into the same test binary)
int zl_udp_open(int, int, int);
void zl_udp_close(int);
int zl_udp_send(int, const uint8_t*, int, uint32_t, uint16_t);
int zl_udp_recv_batch2(int, uint8_t*, int, ZlPacketDesc2*, int, int,
                       const uint64_t*, int, int);
int zl_udp_send_batch(int, const uint8_t*, const ZlSendDesc*, int);
int zl_udp_recv_batch(int, uint8_t*, int, ZlPacketDesc*, int, int);
uint32_t zl_udp_rxq_ovfl();
int zl_udp_buffers(int, int*, int*);
}

#define CHECK(cond) do { if (!(cond)) { \
    std::fprintf(stderr, "FAIL %s:%d: %s\n", __FILE__, __LINE__, #cond); \
    std::exit(1); } } while (0)

static void test_known_answers() {
    // CRC-16/CCITT-FALSE("123456789") == 0x29B1
    CHECK(zl_crc16(reinterpret_cast<const uint8_t*>("123456789"), 9) == 0x29B1);

    uint8_t buf[64];
    int n = zl_build_ack(buf, 31337, 5, 999);
    CHECK(n == 26);
    ZlHeader hdr;
    CHECK(zl_validate_packet(buf, n, &hdr) == 0);
    CHECK(hdr.type == 8 && hdr.sequence == 5 && hdr.timestamp == 999);
    uint32_t acked;
    std::memcpy(&acked, buf + 22, 4);
    CHECK(acked == 31337);

    // Corruption must be detected.
    buf[23] ^= 0xFF;
    CHECK(zl_validate_packet(buf, n, &hdr) == 4);
    buf[23] ^= 0xFF;
    CHECK(zl_validate_packet(buf, n - 1, &hdr) == 3);
    CHECK(zl_validate_packet(buf, 10, &hdr) == 1);
    buf[0] ^= 1;
    CHECK(zl_validate_packet(buf, n, &hdr) == 2);
}

static void test_detection_result() {
    float dets[2][6] = {{0.5f, 0.25f, 0.1f, 0.2f, 0.9f, 2.0f},
                        {0.1f, 0.2f, 0.3f, 0.4f, 0.7f, 0.0f}};
    uint32_t tids[2] = {11, 22};
    std::vector<uint8_t> buf(22 + 14 + 40 * 2);
    int n = zl_build_detection_result(buf.data(), 1234, 5678, &dets[0][0],
                                      tids, 4242, 2, 3, 777);
    CHECK(n == static_cast<int>(buf.size()));
    ZlHeader hdr;
    CHECK(zl_validate_packet(buf.data(), n, &hdr) == 0);
    CHECK(hdr.type == 4 && hdr.length == 14 + 80);
    uint16_t count;
    std::memcpy(&count, buf.data() + 22 + 12, 2);
    CHECK(count == 2);
    // Detection struct padding bytes must be zeroed (deterministic wire).
    for (int i = 0; i < 2; i++) {
        const uint8_t* d = buf.data() + 22 + 14 + 40 * i;
        CHECK(d[28] == 0 && d[29] == 0 && d[30] == 0 && d[31] == 0);
    }
}

static void test_frame_header() {
    // Hand-build a FRAME_DATA packet body.
    std::vector<uint8_t> pkt(22 + 17 + 5, 0xAB);
    uint32_t magic = 0x59544C5A;
    std::memcpy(pkt.data(), &magic, 4);
    pkt[4] = 1; pkt[5] = 3;
    uint16_t len = 22;
    std::memcpy(pkt.data() + 6, &len, 2);
    uint32_t fid = 9; std::memcpy(pkt.data() + 22, &fid, 4);
    uint64_t ts = 100; std::memcpy(pkt.data() + 26, &ts, 8);
    uint16_t w = 10, h = 20;
    std::memcpy(pkt.data() + 34, &w, 2);
    std::memcpy(pkt.data() + 36, &h, 2);
    pkt[38] = 1;
    ZlFrameHeader fh;
    CHECK(zl_parse_frame_header(pkt.data(), pkt.size(), &fh) == 0);
    CHECK(fh.frame_id == 9 && fh.width == 10 && fh.height == 20 && fh.keyframe == 1);
    CHECK(fh.payload_offset == 39 && fh.payload_size == 5);
    // Zero dimensions rejected.
    std::memset(pkt.data() + 34, 0, 2);
    CHECK(zl_parse_frame_header(pkt.data(), pkt.size(), &fh) == 1);

    // Detection-count cap: 14 + 40*n must fit the u16 body length. 1638 is
    // the largest legal n; 1639 must be REJECTED, not silently truncated
    // (regression: the old 0xFFFF guard shipped corrupt packets).
    {
        const int kMax = (0xFFFF - 14) / 40;  // 1638
        std::vector<float> dets(static_cast<size_t>(kMax + 1) * 6, 0.25f);
        std::vector<uint32_t> tids(kMax + 1, 1);
        std::vector<uint8_t> big(22 + 14 + 40 * (kMax + 1));
        CHECK(zl_build_detection_result(big.data(), 1, 2, dets.data(),
                                        tids.data(), 3, kMax + 1, 4, 5) == -1);
        int sz = zl_build_detection_result(big.data(), 1, 2, dets.data(),
                                           tids.data(), 3, kMax, 4, 5);
        CHECK(sz == 22 + 14 + 40 * kMax);
        ZlHeader big_hdr;
        CHECK(zl_validate_packet(big.data(), sz, &big_hdr) == 0);
        CHECK(big_hdr.length == 14 + 40 * kMax);
        // NaN class_id must serialize as a defined value (0), not UB.
        float bad[6] = {0.1f, 0.2f, 0.05f, 0.05f, 0.9f,
                        std::numeric_limits<float>::quiet_NaN()};
        uint32_t tid = 7;
        uint8_t small[22 + 14 + 40];
        CHECK(zl_build_detection_result(small, 1, 2, bad, &tid, 3, 1, 4, 5)
              == 22 + 14 + 40);
        int32_t cls;
        std::memcpy(&cls, small + 22 + 14 + 20, 4);
        CHECK(cls == 0);
    }
}

static uint16_t local_port(int fd) {
    sockaddr_in a{};
    socklen_t len = sizeof(a);
    CHECK(::getsockname(fd, reinterpret_cast<sockaddr*>(&a), &len) == 0);
    return a.sin_port;  // network order
}

static void test_udp_transport() {
    const uint32_t loop_be = htonl(INADDR_LOOPBACK);
    int a = zl_udp_open(0, 1 << 20, 1 << 20);
    int b = zl_udp_open(0, 1 << 20, 1 << 20);
    CHECK(a >= 0 && b >= 0);
    uint16_t pa = local_port(a), pb = local_port(b);

    // b -> a: one valid heartbeat from a REGISTERED peer => validated,
    // typed, and ACKed inline by recv_batch2.
    uint8_t hb[26];
    int n = zl_build_heartbeat(hb, 7, 42, 1000);
    CHECK(zl_udp_send(b, hb, n, loop_be, pa) == n);
    // ...plus one garbage datagram => flags 0, no ACK.
    CHECK(zl_udp_send(b, reinterpret_cast<const uint8_t*>("garbage"), 7,
                      loop_be, pa) == 7);

    uint64_t peer_b = (static_cast<uint64_t>(loop_be) << 16) | pb;
    std::vector<uint8_t> arena(64 * 2048);
    ZlPacketDesc2 descs[64];
    int got = 0, valid = 0, acked = 0;
    for (int tries = 0; tries < 20 && got < 2; tries++) {
        int r = zl_udp_recv_batch2(a, arena.data(), arena.size(), descs + got,
                                   64 - got, 200, &peer_b, 1, 1);
        CHECK(r >= 0);
        got += r;
    }
    CHECK(got == 2);
    for (int i = 0; i < got; i++) {
        if (descs[i].flags & 1) {
            valid++;
            CHECK(descs[i].type == 0 && descs[i].sequence == 42);
            CHECK(descs[i].flags & 2);
            acked++;
        }
    }
    CHECK(valid == 1 && acked == 1);

    // b receives exactly one ACK carrying the heartbeat's sequence.
    ZlPacketDesc2 bdescs[8];
    int br = 0;
    for (int tries = 0; tries < 20 && br < 1; tries++) {
        int r = zl_udp_recv_batch2(b, arena.data(), arena.size(), bdescs + br,
                                   8 - br, 200, nullptr, 0, 0);
        CHECK(r >= 0);  // a negative errno must not walk the pointer back
        br += r;
    }
    CHECK(br == 1);
    CHECK((bdescs[0].flags & 1) && bdescs[0].type == 8);
    uint32_t acked_seq;
    std::memcpy(&acked_seq, arena.data() + bdescs[0].offset + 22, 4);
    CHECK(acked_seq == 42);

    // UNREGISTERED peer: valid packet, no ACK generated.
    CHECK(zl_udp_send(b, hb, n, loop_be, pa) == n);
    int r2 = 0;
    ZlPacketDesc2 d2[8];
    for (int tries = 0; tries < 20 && r2 < 1; tries++) {
        int r = zl_udp_recv_batch2(a, arena.data(), arena.size(), d2 + r2,
                                   8 - r2, 200, nullptr, 0, 1);
        CHECK(r >= 0);
        r2 += r;
    }
    CHECK(r2 == 1 && (d2[0].flags & 1) && !(d2[0].flags & 2));

    // send_batch: 3 packets in one sendmmsg, all delivered.
    std::vector<uint8_t> sarena(3 * 26);
    ZlSendDesc sd[3];
    for (int i = 0; i < 3; i++) {
        zl_build_heartbeat(sarena.data() + i * 26, 100 + i, 50 + i, 2000);
        sd[i] = {static_cast<uint32_t>(i * 26), 26, loop_be, pb, 0};
    }
    CHECK(zl_udp_send_batch(a, sarena.data(), sd, 3) == 3);
    int br2 = 0;
    ZlPacketDesc2 d3[8];
    for (int tries = 0; tries < 20 && br2 < 3; tries++) {
        int r = zl_udp_recv_batch2(b, arena.data(), arena.size(), d3 + br2,
                                   8 - br2, 200, nullptr, 0, 0);
        CHECK(r >= 0);
        br2 += r;
    }
    CHECK(br2 == 3);
    for (int i = 0; i < 3; i++) {
        CHECK((d3[i].flags & 1) && d3[i].type == 0);
    }
    zl_udp_close(a);
    zl_udp_close(b);
    std::printf("udp transport: all checks passed\n");
}

// The port's additions to udp.cpp: the granted buffer sizes, and the drop
// count SO_RXQ_OVFL carries on each datagram received after a drop.
static void test_udp_buffers_and_drops() {
    const uint32_t loop_be = htonl(INADDR_LOOPBACK);
    // zl_udp_buffers reads back what the kernel granted (it doubles a
    // request and caps it at rmem_max / wmem_max): the same sizes as
    // getsockopt.
    int a = zl_udp_open(0, 1 << 20, 1 << 19);
    CHECK(a >= 0);
    int rcv = -1, snd = -1;
    CHECK(zl_udp_buffers(a, &rcv, &snd) == 0);
    int want_rcv = 0, want_snd = 0;
    socklen_t len = sizeof(int);
    CHECK(::getsockopt(a, SOL_SOCKET, SO_RCVBUF, &want_rcv, &len) == 0);
    len = sizeof(int);
    CHECK(::getsockopt(a, SOL_SOCKET, SO_SNDBUF, &want_snd, &len) == 0);
    CHECK(rcv == want_rcv && snd == want_snd && rcv > 0 && snd > 0);
    CHECK(zl_udp_buffers(-1, &rcv, &snd) < 0);  // a bad fd is -errno
    zl_udp_close(a);

    // Before any drop the count is 0.
    CHECK(zl_udp_rxq_ovfl() == 0);

    // A flood into a small receive buffer nobody reads: the kernel drops
    // what does not fit. Then drain it, send one more datagram and read it:
    // that datagram carries the socket's drop count.
    int sink = zl_udp_open(0, 4096, 0);
    int src = zl_udp_open(0, 0, 1 << 20);
    CHECK(sink >= 0 && src >= 0);
    const uint16_t ps = local_port(sink);
    std::vector<uint8_t> payload(1024, 0x5A);
    const int kFlood = 2000;
    int sent = 0;
    for (int i = 0; i < kFlood; i++) {
        if (zl_udp_send(src, payload.data(), payload.size(), loop_be, ps)
            == static_cast<int>(payload.size())) sent++;
    }
    std::vector<uint8_t> arena(64 * 2048);
    ZlPacketDesc descs[64];
    int received = 0;
    uint32_t last = 0;
    for (;;) {
        int r = zl_udp_recv_batch(sink, arena.data(), arena.size(), descs,
                                  64, 100);
        CHECK(r >= 0);
        if (r == 0) break;
        received += r;
        CHECK(zl_udp_rxq_ovfl() >= last);  // the count never decreases
        last = zl_udp_rxq_ovfl();
    }
    const int dropped = sent - received;
    CHECK(dropped >= 0);
    CHECK(zl_udp_send(src, payload.data(), payload.size(), loop_be, ps)
          == static_cast<int>(payload.size()));
    int got = 0;
    for (int tries = 0; tries < 20 && got < 1; tries++) {
        int r = zl_udp_recv_batch(sink, arena.data(), arena.size(), descs,
                                  64, 200);
        CHECK(r >= 0);
        got += r;
    }
    CHECK(got == 1);
    const uint32_t ovfl = zl_udp_rxq_ovfl();
    CHECK(ovfl >= last);
    if (dropped == 0) {
        std::printf("udp drops: %d of %d datagrams fit the buffer, none "
                    "dropped; the drop count stays %u\n", received, sent, ovfl);
        CHECK(ovfl == 0);
    } else if (ovfl == 0) {
        std::printf("udp drops: %d of %d datagrams dropped; this kernel "
                    "reports no SO_RXQ_OVFL count (not checked)\n",
                    dropped, sent);
    } else {
        std::printf("udp drops: %d of %d datagrams dropped, SO_RXQ_OVFL "
                    "counts %u\n", dropped, sent, ovfl);
        CHECK(ovfl == static_cast<uint32_t>(dropped));
    }
    zl_udp_close(sink);
    zl_udp_close(src);
}

static void fuzz(int iters) {
    std::mt19937 rng(1234);
    uint8_t base[512];
    float dets[4][6] = {};
    uint32_t tids[4] = {1, 2, 3, 4};
    int n = zl_build_detection_result(base, 1, 2, &dets[0][0], tids, 3, 4, 5, 6);
    std::vector<uint8_t> buf;
    for (int i = 0; i < iters; i++) {
        size_t size = rng() % (n + 32);
        buf.assign(base, base + n);
        buf.resize(size > 0 ? size : 1);
        int flips = rng() % 8;
        for (int f = 0; f < flips && !buf.empty(); f++) {
            buf[rng() % buf.size()] ^= static_cast<uint8_t>(rng());
        }
        ZlHeader hdr;
        zl_validate_packet(buf.data(), buf.size(), &hdr);  // must not crash
        ZlFrameHeader fh;
        zl_parse_frame_header(buf.data(), buf.size(), &fh);
    }
    std::printf("fuzz: %d iterations clean\n", iters);
}

int main(int argc, char** argv) {
    if (argc > 1 && std::strcmp(argv[1], "fuzz") == 0) {
        fuzz(argc > 2 ? std::atoi(argv[2]) : 100000);
        return 0;
    }
    test_known_answers();
    test_detection_result();
    test_frame_header();
    test_udp_transport();
    test_udp_buffers_and_drops();
    std::printf("codec_test: all checks passed\n");
    return 0;
}
