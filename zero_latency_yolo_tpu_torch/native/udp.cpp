// Native UDP transport core: batched datagram intake via recvmmsg.
//
// Native replacement for the reference's per-datagram recvfrom thread
// (reference: src/network/reliable_udp.cpp:465-539, one recvfrom + 100us
// sleep per loop). Here a single syscall drains up to ZL_RECV_BATCH packets
// into a caller-provided arena; ctypes releases the GIL for the call's
// duration, so Python threads keep running while this blocks in poll().
//
// API (all little-endian host structs, IPv4):
//   zl_udp_open(port, rcvbuf, sndbuf) -> fd (or -errno); binds 0.0.0.0:port
//   zl_udp_open2(port, rcvbuf, sndbuf, flags) -> as above; flags bit 0 sets
//       SO_REUSEPORT (kernel flow-hash sharding across N server processes —
//       every binder must opt in, so it cannot steal a normal bind)
//   zl_udp_open3(ip, port, rcvbuf, sndbuf, flags) -> as above, bound to a
//       specific IPv4 address (NULL/"" = INADDR_ANY); -EINVAL on a
//       non-IPv4-dotted string
//   zl_udp_recv_batch(fd, arena, arena_cap, pkts, max_pkts, timeout_ms)
//       -> n packets written (0 on timeout, -errno on error)
//   zl_udp_recv_batch2(...)  -> as above, but each datagram is ZLTY-validated
//       in C++ (header + CRC, via the codec in this library) and valid
//       non-ACK packets from known peers are ACKed inline with ONE sendmmsg
//       — the ACK never crosses into Python (reference ACK-all semantics,
//       src/network/reliable_udp.cpp:602-605, minus two thread hops)
//   zl_udp_send(fd, data, len, ip_be, port_be) -> sent bytes or -errno
//   zl_udp_send_batch(fd, arena, descs, n) -> sendmmsg burst (result sends)
//   zl_udp_close(fd)

#include <arpa/inet.h>
#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <netinet/in.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

#include "codec.h"  // ZlHeader + codec prototypes (same shared object)

extern "C" {

static const int ZL_RECV_BATCH_MAX = 128;

static const int ZL_OPEN_REUSEPORT = 1;

int zl_udp_open3(const char* ip, int port, int rcvbuf, int sndbuf,
                 int flags) {
    // SOCK_CLOEXEC: Python sockets are close-on-exec by default (PEP 446);
    // without it this fd leaks into forked children (ffmpeg, make) and a
    // lingering child keeps the port bound across server restarts.
    int fd = ::socket(AF_INET, SOCK_DGRAM | SOCK_CLOEXEC, 0);
    if (fd < 0) return -errno;
    // NOTE: no SO_REUSEADDR — on UDP it lets a second instance bind the
    // same port and silently steal all traffic; the server's port-busy
    // handling wants a clean EADDRINUSE so it can fall back to port+1.
    // SO_REUSEPORT is different: the kernel flow-hashes datagrams across
    // the group of sockets that ALL opted in (per-4-tuple sticky), and an
    // existing plain bind still yields EADDRINUSE — the multi-process
    // host-sharding mode (network.reuse_port).
    if (flags & ZL_OPEN_REUSEPORT) {
        int one = 1;
        if (::setsockopt(fd, SOL_SOCKET, SO_REUSEPORT, &one, sizeof(one)) != 0) {
            int e = errno;
            ::close(fd);
            return -e;
        }
    }
    if (rcvbuf > 0) ::setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &rcvbuf, sizeof(rcvbuf));
    if (sndbuf > 0) ::setsockopt(fd, SOL_SOCKET, SO_SNDBUF, &sndbuf, sizeof(sndbuf));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
    if (ip != nullptr && ip[0] != '\0') {
        // Interface-scoped bind (network.bind_address). inet_pton rejects
        // anything but dotted IPv4 — a hostname or IPv6 literal must fail
        // here, not bind INADDR_ANY and silently listen everywhere.
        if (::inet_pton(AF_INET, ip, &addr.sin_addr) != 1) {
            ::close(fd);
            return -EINVAL;
        }
    }
    addr.sin_port = htons(static_cast<uint16_t>(port));
    if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
        int e = errno;
        ::close(fd);
        return -e;
    }
    return fd;
}

int zl_udp_open2(int port, int rcvbuf, int sndbuf, int flags) {
    return zl_udp_open3(nullptr, port, rcvbuf, sndbuf, flags);
}

int zl_udp_open(int port, int rcvbuf, int sndbuf) {
    return zl_udp_open3(nullptr, port, rcvbuf, sndbuf, 0);
}

// Shared intake prologue: poll, slot the arena, one recvmmsg. Fills the
// file-scope thread_local g_msgs/g_addrs for the caller to read back.
// Returns n datagrams (0 = timeout/empty), or -errno. ONE copy of this —
// a fix applied to v1 and missed in v2 (or vice versa) silently splits
// their intake behavior.
static thread_local mmsghdr g_msgs[ZL_RECV_BATCH_MAX];
static thread_local iovec g_iovs[ZL_RECV_BATCH_MAX];
static thread_local sockaddr_in g_addrs[ZL_RECV_BATCH_MAX];

static int zl_recv_prologue(int fd, uint8_t* arena, int arena_cap,
                            int* max_pkts, int timeout_ms, int* slot_out) {
    if (*max_pkts > ZL_RECV_BATCH_MAX) *max_pkts = ZL_RECV_BATCH_MAX;
    // Guard the slot division: these are extern-C ABI entry points; a bad
    // caller value must be -EINVAL, not a process-fatal SIGFPE.
    if (*max_pkts <= 0 || arena_cap <= 0) return -EINVAL;
    pollfd pfd{fd, POLLIN, 0};
    int pr = ::poll(&pfd, 1, timeout_ms);
    if (pr < 0) return errno == EINTR ? 0 : -errno;
    if (pr == 0) return 0;

    const int slot = arena_cap / *max_pkts;
    for (int i = 0; i < *max_pkts; i++) {
        g_iovs[i].iov_base = arena + i * slot;
        g_iovs[i].iov_len = slot;
        std::memset(&g_msgs[i], 0, sizeof(mmsghdr));
        g_msgs[i].msg_hdr.msg_iov = &g_iovs[i];
        g_msgs[i].msg_hdr.msg_iovlen = 1;
        g_msgs[i].msg_hdr.msg_name = &g_addrs[i];
        g_msgs[i].msg_hdr.msg_namelen = sizeof(sockaddr_in);
    }
    int n = ::recvmmsg(fd, g_msgs, *max_pkts, MSG_DONTWAIT, nullptr);
    if (n < 0) {
        int e = errno;
        return (e == EAGAIN || e == EWOULDBLOCK || e == EINTR) ? 0 : -e;
    }
    *slot_out = slot;
    return n;
}

int zl_udp_recv_batch(int fd, uint8_t* arena, int arena_cap,
                      ZlPacketDesc* pkts, int max_pkts, int timeout_ms) {
    int slot = 0;
    int n = zl_recv_prologue(fd, arena, arena_cap, &max_pkts, timeout_ms,
                             &slot);
    if (n <= 0) return n;
    for (int i = 0; i < n; i++) {
        pkts[i].offset = static_cast<uint32_t>(i * slot);
        pkts[i].length = g_msgs[i].msg_len;
        pkts[i].ip_be = g_addrs[i].sin_addr.s_addr;
        pkts[i].port_be = g_addrs[i].sin_port;
        pkts[i]._pad = 0;
    }
    return n;
}

// ---------------------------------------------------------------------------
// v2 receive: ZLTY validation + inline ACK generation on the drain thread.
//
// Each datagram is validated (magic/version/length/CRC) right in the intake
// batch; valid non-ACK packets whose sender is in the caller-provided peer
// table are ACKed with ONE sendmmsg before returning. Python receives
// pre-parsed headers (no second CRC pass over JPEG payloads) and skips the
// two thread-hops the ACK used to take (drain -> loop -> sendto).

static const uint8_t ZL_F_VALID = 1;
static const uint8_t ZL_F_ACKED = 2;
static const int ZL_ACK_SIZE = 26;

// Inline ACK sequences live in [2^31, 2^32): Python's next_sequence mints
// in [1, 2^31) (packets.py), so the two spaces never collide even on
// long-running servers.
static std::atomic<uint32_t> g_ack_seq{0x80000000u};

static uint64_t zl_now_ms() {
    timespec ts;
    clock_gettime(CLOCK_REALTIME, &ts);
    return static_cast<uint64_t>(ts.tv_sec) * 1000u + ts.tv_nsec / 1000000u;
}

// peers: sorted array of ((uint64)ip_be << 16) | port_be keys.
static bool zl_peer_known(const uint64_t* peers, int n_peers, uint64_t key) {
    int lo = 0, hi = n_peers;
    while (lo < hi) {
        int mid = (lo + hi) / 2;
        if (peers[mid] < key) lo = mid + 1;
        else hi = mid;
    }
    return lo < n_peers && peers[lo] == key;
}

int zl_udp_recv_batch2(int fd, uint8_t* arena, int arena_cap,
                       ZlPacketDesc2* pkts, int max_pkts, int timeout_ms,
                       const uint64_t* peers, int n_peers, int do_ack) {
    int slot = 0;
    int n = zl_recv_prologue(fd, arena, arena_cap, &max_pkts, timeout_ms,
                             &slot);
    if (n <= 0) return n;
    mmsghdr* msgs = g_msgs;
    sockaddr_in* addrs = g_addrs;

    static thread_local uint8_t ack_buf[ZL_RECV_BATCH_MAX * ZL_ACK_SIZE];
    static thread_local mmsghdr ack_msgs[ZL_RECV_BATCH_MAX];
    static thread_local iovec ack_iovs[ZL_RECV_BATCH_MAX];
    static thread_local sockaddr_in ack_addrs[ZL_RECV_BATCH_MAX];
    static thread_local int ack_pkt_idx[ZL_RECV_BATCH_MAX];
    int n_acks = 0;
    const uint64_t now = zl_now_ms();

    for (int i = 0; i < n; i++) {
        ZlPacketDesc2& d = pkts[i];
        d.offset = static_cast<uint32_t>(i * slot);
        d.length = msgs[i].msg_len;
        d.ip_be = addrs[i].sin_addr.s_addr;
        d.port_be = addrs[i].sin_port;
        d._pad = 0;
        ZlHeader hdr{};
        if (zl_validate_packet(arena + d.offset, d.length, &hdr) != 0) {
            d.flags = 0;
            d.type = 0;
            d.sequence = 0;
            d.timestamp = 0;
            continue;
        }
        d.flags = ZL_F_VALID;
        d.type = hdr.type;
        d.sequence = hdr.sequence;
        d.timestamp = hdr.timestamp;
        if (!do_ack || hdr.type == 8 /*ACK*/) continue;
        const uint64_t key =
            (static_cast<uint64_t>(d.ip_be) << 16) | d.port_be;
        if (!zl_peer_known(peers, n_peers, key)) continue;
        uint8_t* ab = ack_buf + n_acks * ZL_ACK_SIZE;
        // OR the top bit so the sequence stays in the reserved ACK space
        // even after the counter wraps.
        zl_build_ack(ab, hdr.sequence,
                     0x80000000u |
                         g_ack_seq.fetch_add(1, std::memory_order_relaxed),
                     now);
        ack_iovs[n_acks].iov_base = ab;
        ack_iovs[n_acks].iov_len = ZL_ACK_SIZE;
        ack_addrs[n_acks] = addrs[i];
        std::memset(&ack_msgs[n_acks], 0, sizeof(mmsghdr));
        ack_msgs[n_acks].msg_hdr.msg_iov = &ack_iovs[n_acks];
        ack_msgs[n_acks].msg_hdr.msg_iovlen = 1;
        ack_msgs[n_acks].msg_hdr.msg_name = &ack_addrs[n_acks];
        ack_msgs[n_acks].msg_hdr.msg_namelen = sizeof(sockaddr_in);
        d.flags |= ZL_F_ACKED;
        ack_pkt_idx[n_acks] = i;
        n_acks++;
    }
    if (n_acks > 0) {
        int sent = 0;
        while (sent < n_acks) {
            // MSG_DONTWAIT: this runs on the INTAKE thread. A full SNDBUF
            // must drop the ACK tail to the Python fallback, not block the
            // one thread doing recvmmsg — stalled intake drops frames for
            // every client, a far worse trade than a late ACK.
            int r = ::sendmmsg(fd, ack_msgs + sent, n_acks - sent,
                               MSG_DONTWAIT);
            if (r <= 0) break;  // best-effort: retransmit covers losses
            sent += r;
        }
        // ZL_F_ACKED was set when the ACK was QUEUED; clear it on any
        // unsent tail so Python falls back to a per-packet ACK (and its
        // packets_sent/bytes_sent counters only ever count ACKs that
        // actually left the socket).
        for (int j = sent; j < n_acks; j++)
            pkts[ack_pkt_idx[j]].flags &= static_cast<uint8_t>(~ZL_F_ACKED);
    }
    return n;
}

// One sendmmsg for a burst of result packets. Returns packets sent.
int zl_udp_send_batch(int fd, const uint8_t* arena, const ZlSendDesc* descs,
                      int n) {
    if (n <= 0) return 0;
    static thread_local mmsghdr msgs[ZL_RECV_BATCH_MAX];
    static thread_local iovec iovs[ZL_RECV_BATCH_MAX];
    static thread_local sockaddr_in addrs[ZL_RECV_BATCH_MAX];
    int done = 0;
    while (done < n) {
        int chunk = n - done;
        if (chunk > ZL_RECV_BATCH_MAX) chunk = ZL_RECV_BATCH_MAX;
        for (int i = 0; i < chunk; i++) {
            const ZlSendDesc& d = descs[done + i];
            iovs[i].iov_base = const_cast<uint8_t*>(arena) + d.offset;
            iovs[i].iov_len = d.length;
            std::memset(&addrs[i], 0, sizeof(sockaddr_in));
            addrs[i].sin_family = AF_INET;
            addrs[i].sin_addr.s_addr = d.ip_be;
            addrs[i].sin_port = d.port_be;
            std::memset(&msgs[i], 0, sizeof(mmsghdr));
            msgs[i].msg_hdr.msg_iov = &iovs[i];
            msgs[i].msg_hdr.msg_iovlen = 1;
            msgs[i].msg_hdr.msg_name = &addrs[i];
            msgs[i].msg_hdr.msg_namelen = sizeof(sockaddr_in);
        }
        // MSG_DONTWAIT: result bursts run on the asyncio event-loop thread
        // — a full SNDBUF must surface as a partial send (the caller
        // single-retries the boundary message), not block the loop that
        // handles every control packet and heartbeat.
        int r = ::sendmmsg(fd, msgs, chunk, MSG_DONTWAIT);
        if (r < 0) {
            int e = errno;
            return done > 0 ? done : -e;
        }
        done += r;
        if (r < chunk) break;  // kernel backpressure: report partial send
    }
    return done;
}

int zl_udp_send(int fd, const uint8_t* data, int len,
                uint32_t ip_be, uint16_t port_be) {
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = ip_be;
    addr.sin_port = port_be;
    // MSG_DONTWAIT: single sends run on the asyncio event-loop thread
    // (ACKs, heartbeats, the send_many boundary retry) — a full SNDBUF
    // must surface as -EAGAIN (counted as a send drop), never block the
    // loop that handles every control packet.
    ssize_t sent = ::sendto(fd, data, len, MSG_DONTWAIT,
                            reinterpret_cast<sockaddr*>(&addr), sizeof(addr));
    return sent < 0 ? -errno : static_cast<int>(sent);
}

void zl_udp_close(int fd) {
    if (fd >= 0) ::close(fd);
}

}  // extern "C"
