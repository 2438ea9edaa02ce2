// Native Neato XV11 protocol parser (bulk .bin log replay hot path).
//
// Behavior parity: slamrs/neato/src/frame.rs —
//   * parse_packet/parse_data/checksum (frame.rs:74-122): 22-byte packets,
//     0xFA start, index 0xA0..0xF9, 14-bit little-endian distances, valid
//     bit = !(b1 & 0x80), word-fold checksum;
//   * parse_packets (frame.rs:136-201): byte-by-byte re-sync scanning for
//     0xFA (advancing ONE byte even after a valid packet — kept), checksum
//     gate, revolution emitted when the packet index wraps below the
//     previous one, trailing partial revolution not emitted;
//   * parse_frame (frame.rs:124-134): 90 consecutive packets, checksum NOT
//     enforced on this path.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).
//
// Build: g++ -O3 -shared -fPIC -o libneato.so neato_parser.cpp

#include <cstdint>
#include <cstring>

namespace {

constexpr int kPacketBytes = 22;
constexpr int kPacketsPerRev = 90;
constexpr int kBeams = 360;
constexpr uint8_t kStart = 0xFA;
constexpr uint8_t kIndexBase = 0xA0;

bool checksum_valid(const uint8_t* p) {
    uint32_t chk32 = 0;
    for (int i = 0; i < 10; ++i) {
        uint32_t word = static_cast<uint32_t>(p[2 * i]) |
                        (static_cast<uint32_t>(p[2 * i + 1]) << 8);
        chk32 = (chk32 << 1) + word;
    }
    uint32_t checksum = (chk32 & 0x7FFF) + (chk32 >> 15);
    checksum &= 0x7FFF;
    uint16_t stored = static_cast<uint16_t>(p[20]) |
                      (static_cast<uint16_t>(p[21]) << 8);
    return checksum == static_cast<uint16_t>(stored);
}

// Decode the 4 readings of a packet into per-beam slots.
void decode_readings(const uint8_t* p, int packet_index, uint16_t* distance,
                     uint16_t* strength, uint8_t* valid) {
    for (int j = 0; j < 4; ++j) {
        const uint8_t* b = p + 4 + 4 * j;
        int lane = packet_index * 4 + j;
        distance[lane] = static_cast<uint16_t>(b[0]) |
                         (static_cast<uint16_t>(b[1] & 0x3F) << 8);
        strength[lane] = static_cast<uint16_t>(b[2]) |
                         (static_cast<uint16_t>(b[3]) << 8);
        valid[lane] = (b[1] & 0x80) == 0 ? 1 : 0;
    }
}

}  // namespace

extern "C" {

// Parse one 1980-byte frame (frame.rs:124-134).  Buffers are [360].
void neato_parse_frame(const uint8_t* data, uint16_t* distance,
                       uint16_t* strength, uint8_t* valid) {
    std::memset(distance, 0, kBeams * sizeof(uint16_t));
    std::memset(strength, 0, kBeams * sizeof(uint16_t));
    std::memset(valid, 0, kBeams);
    for (int i = 0; i < kPacketsPerRev; ++i) {
        decode_readings(data + i * kPacketBytes, i, distance, strength,
                        valid);
    }
}

// Stream parser (frame.rs:136-201).  Output buffers hold max_frames
// revolutions of 360 lanes each; returns the number of frames written
// (negative if max_frames was insufficient).  Pass max_frames=0 with null
// outputs to count frames.
long neato_parse_packets(const uint8_t* data, long len, uint16_t* distances,
                         uint16_t* strengths, uint8_t* valids,
                         long max_frames) {
    uint16_t dist[kBeams];
    uint16_t stren[kBeams];
    uint8_t val[kBeams];
    std::memset(dist, 0, sizeof(dist));
    std::memset(stren, 0, sizeof(stren));
    std::memset(val, 0, sizeof(val));

    long frames = 0;
    int last_index = 0;
    const bool counting = (max_frames == 0);

    for (long i = 0; i + kPacketBytes <= len; ++i) {
        if (data[i] != kStart) continue;
        const uint8_t* p = data + i;
        if (!checksum_valid(p)) continue;   // frame.rs:170-174
        if (p[1] < kIndexBase) continue;    // checked_sub skip (rs:176-181)
        int index = p[1] - kIndexBase;
        if (index >= kPacketsPerRev) continue;
        if (index < last_index) {           // revolution wrap (rs:184-191)
            if (!counting) {
                if (frames >= max_frames) return -1;
                std::memcpy(distances + frames * kBeams, dist, sizeof(dist));
                std::memcpy(strengths + frames * kBeams, stren,
                            sizeof(stren));
                std::memcpy(valids + frames * kBeams, val, sizeof(val));
            }
            ++frames;
            std::memset(dist, 0, sizeof(dist));
            std::memset(stren, 0, sizeof(stren));
            std::memset(val, 0, sizeof(val));
        }
        if (!counting) {
            decode_readings(p, index, dist, stren, val);
        }
        last_index = index;
    }
    return frames;
}

// Checksum check exposed for tests.
int neato_checksum_valid(const uint8_t* packet) {
    return checksum_valid(packet) ? 1 : 0;
}

}  // extern "C"
