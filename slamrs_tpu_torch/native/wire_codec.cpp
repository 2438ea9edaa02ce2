// Native host<->robot wire codec: the robot-link data plane.
//
// Parity: slamrs-message/src/lib.rs (bincode-v2-standard) as consumed by
// the reference's connection stream thread (neato/src/connection.rs:
// 244-298).  Mirrors slamrs_tpu/io/message.py exactly, including the
// stream-drain semantics (decode sequential messages; on a malformed
// variant byte resync by skipping one byte — the python fallback in
// io/connection.py does the same).
//
// Exposed via ctypes (no pybind11 in the image).

#include <cstdint>
#include <cstring>

namespace {

constexpr long kScanBytes = 1980;

// bincode-2 "standard" unsigned varint.  Returns new position or -1 if
// more bytes are needed, -2 on an unsupported marker.
long read_varint(const uint8_t* buf, long len, long pos, uint64_t* out) {
    if (pos >= len) return -1;
    uint8_t b = buf[pos];
    if (b < 251) { *out = b; return pos + 1; }
    if (b == 251) {
        if (pos + 3 > len) return -1;
        uint16_t v; std::memcpy(&v, buf + pos + 1, 2);
        *out = v; return pos + 3;
    }
    if (b == 252) {
        if (pos + 5 > len) return -1;
        uint32_t v; std::memcpy(&v, buf + pos + 1, 4);
        *out = v; return pos + 5;
    }
    if (b == 253) {
        if (pos + 9 > len) return -1;
        uint64_t v; std::memcpy(&v, buf + pos + 1, 8);
        *out = v; return pos + 9;
    }
    return -2;
}

}  // namespace

extern "C" {

// Drain a RobotMessage stream: extract up to max_frames ScanFrames
// (Pong messages are consumed and dropped, like connection.rs:268-270's
// match).  Returns the number of frames extracted; *consumed is advanced
// past every fully-decoded message and every resync-skipped byte, so the
// caller keeps buf[consumed..] for the next read.
long wire_decode_scan_frames(const uint8_t* buf, long len,
                             uint8_t* out_scans,    // [max_frames][1980]
                             float* out_odometry,   // [max_frames][2]
                             uint16_t* out_rpm,     // [max_frames]
                             long max_frames, long* consumed) {
    long pos = 0;
    long n = 0;
    while (n < max_frames) {
        uint64_t disc;
        long p = read_varint(buf, len, pos, &disc);
        if (p == -1) break;              // need more bytes
        if (p == -2 || disc > 1) {       // malformed: resync one byte
            pos += 1;
            continue;
        }
        if (disc == 1) {                 // Pong
            pos = p;
            continue;
        }
        // ScanFrame { scan_data: [u8; 1980], odometry: [f32; 2], rpm: u16 }
        if (p + kScanBytes + 8 > len) break;
        long q = p + kScanBytes + 8;
        uint64_t rpm;
        long r = read_varint(buf, len, q, &rpm);
        if (r == -1) break;
        if (r == -2) { pos += 1; continue; }
        std::memcpy(out_scans + n * kScanBytes, buf + p, kScanBytes);
        std::memcpy(out_odometry + n * 2, buf + p + kScanBytes, 8);
        out_rpm[n] = static_cast<uint16_t>(rpm);
        ++n;
        pos = r;
    }
    *consumed = pos;
    return n;
}

// Encode a CommandMessage (lib.rs:10-26).  kind: 0 Ping, 1 NeatoOn,
// 2 NeatoOff, 3 SetDownsampling{every}, 4 Drive{left,right},
// 5 SetMotorPiParams{kp,ki}.  Returns bytes written (out needs >= 16).
long wire_encode_command(int kind, int every, float left, float right,
                         float kp, float ki, uint8_t* out) {
    long pos = 0;
    out[pos++] = static_cast<uint8_t>(kind);  // discriminants < 251
    switch (kind) {
        case 3:
            out[pos++] = static_cast<uint8_t>(every);
            break;
        case 4:
            std::memcpy(out + pos, &left, 4);
            std::memcpy(out + pos + 4, &right, 4);
            pos += 8;
            break;
        case 5:
            std::memcpy(out + pos, &kp, 4);
            std::memcpy(out + pos + 4, &ki, 4);
            pos += 8;
            break;
        default:
            break;
    }
    return pos;
}

}  // extern "C"
