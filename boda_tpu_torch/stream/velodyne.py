"""Velodyne lidar packet decoding (VLP-16 / HDL-32 data packets).

A copy of ``boda_tpu/stream/velodyne.py`` (pure Python and numpy; the port
imports nothing of boda_tpu), so the packets either package writes the
other reads. Parity target: ref src/data-stream-velo.cc (:103, ~1.1 kLoC): decode raw
1206-byte Velodyne data packets into per-firing (azimuth, distance,
reflectivity) and cartesian point clouds.

Packet layout (both models): 12 data blocks x [0xEEFF flag, u16 azimuth in
0.01 deg, 32 x (u16 distance in 2mm units, u8 reflectivity)] + u32 usec
timestamp + u16 factory bytes.
"""

from __future__ import annotations

import math
import struct

import numpy as np

PACKET_BYTES = 1206
_BLOCKS = 12
_CHANS = 32

# VLP-16 vertical (elevation) angles, firing order (degrees)
VLP16_ELEV = [-15, 1, -13, 3, -11, 5, -9, 7, -7, 9, -5, 11, -3, 13, -1, 15]


class VeloError(ValueError):
    pass


def decode_packet(pkt: bytes):
    """One packet -> (azimuths[12], dists[12,32] meters, refl[12,32], ts_usec)."""
    if len(pkt) != PACKET_BYTES:
        raise VeloError(f"velodyne packet must be {PACKET_BYTES} bytes, "
                        f"got {len(pkt)}")
    az = np.empty(_BLOCKS, np.float32)
    dist = np.empty((_BLOCKS, _CHANS), np.float32)
    refl = np.empty((_BLOCKS, _CHANS), np.uint8)
    off = 0
    for b in range(_BLOCKS):
        flag, azi = struct.unpack_from("<HH", pkt, off)
        if flag != 0xEEFF:
            raise VeloError(f"block {b}: bad flag 0x{flag:04X} (want 0xEEFF)")
        az[b] = azi * 0.01
        off += 4
        # interleaved (u16 dist, u8 refl) records: decode via bytes view
        rec = np.frombuffer(pkt, dtype=np.uint8, count=_CHANS * 3, offset=off)
        rec = rec.reshape(_CHANS, 3)
        dist[b] = (rec[:, 0].astype(np.uint16) |
                   (rec[:, 1].astype(np.uint16) << 8)).astype(np.float32) * 0.002
        refl[b] = rec[:, 2]
        off += _CHANS * 3
    (ts_usec,) = struct.unpack_from("<I", pkt, off)
    return az, dist, refl, ts_usec


def packet_to_points_vlp16(pkt: bytes) -> np.ndarray:
    """Decode one packet to an (N, 4) float32 array of (x, y, z, refl).
    VLP-16 fires its 16 lasers twice per 32-channel block."""
    az, dist, refl, _ = decode_packet(pkt)
    pts = []
    elev = np.deg2rad(np.array(VLP16_ELEV, np.float32))
    for b in range(_BLOCKS):
        a = math.radians(az[b])
        sin_a, cos_a = np.float32(math.sin(a)), np.float32(math.cos(a))
        for half in range(2):
            d = dist[b, half * 16:(half + 1) * 16]
            r = refl[b, half * 16:(half + 1) * 16]
            mask = d > 0
            if not mask.any():
                continue
            dm = d[mask]
            el = elev[mask]
            xy = dm * np.cos(el)
            pts.append(np.stack([xy * sin_a, xy * cos_a,
                                 dm * np.sin(el),
                                 r[mask].astype(np.float32)], axis=1))
    return np.concatenate(pts, axis=0) if pts else np.zeros((0, 4), np.float32)


def encode_packet(az_deg: np.ndarray, dist_m: np.ndarray, refl: np.ndarray,
                  ts_usec: int = 0) -> bytes:
    """Synthesize a valid packet (test fixture generator)."""
    out = bytearray()
    for b in range(_BLOCKS):
        out += struct.pack("<HH", 0xEEFF, int(az_deg[b] * 100))
        for c in range(_CHANS):
            d = int(dist_m[b, c] / 0.002)
            out += struct.pack("<HB", d & 0xFFFF, int(refl[b, c]))
    out += struct.pack("<IH", ts_usec, 0x2237)
    assert len(out) == PACKET_BYTES
    return bytes(out)
