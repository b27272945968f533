"""Data-stream pipeline modes.

Counterpart of ``boda_tpu/modes/stream_modes.py``, on the port's own
stream package. Parity targets: the ``pipe`` composition + ``scan-data-stream`` flows
(ref src/data-stream.cc:729 and mode census) and the velodyne decode path
(ref src/data-stream-velo.cc).
"""

from __future__ import annotations

from .. import stream  # noqa: F401
from ..config import Field, Mode, register


@register("mode", "scan_data_stream", help="run a data-stream pipeline to exhaustion")
class ScanDataStream(Mode):
    src = Field("data_stream", req=True, help="source (possibly nested transforms)")
    sink = Field("data_stream", default="(stream=print-sink)", help="sink")
    max_blocks = Field(int, default="0", help="stop after N blocks (0=all)")

    def main(self) -> None:
        self.src.start()
        self.sink.start()
        n = 0
        while True:
            b = self.src.read()
            if b is None:
                break
            self.sink.proc(b)
            n += 1
            if self.max_blocks and n >= self.max_blocks:
                break
        self.sink.finish()
        print(f"scan_data_stream: {n} blocks")


@register("mode", "velo_scan", help="decode a raw velodyne packet file to points")
class VeloScan(Mode):
    fn = Field("filename", req=True, help="raw packet file (1206-byte packets)")
    max_packets = Field(int, default="0", help="packet limit (0=all)")
    csv_fn = Field(str, default="", help="write points csv (x,y,z,refl)")

    def main(self) -> None:
        from ..stream.velodyne import PACKET_BYTES, packet_to_points_vlp16
        n_pkt = n_pts = 0
        rows = []
        with open(self.fn, "rb") as f:
            while True:
                pkt = f.read(PACKET_BYTES)
                if len(pkt) < PACKET_BYTES:
                    break
                pts = packet_to_points_vlp16(pkt)
                n_pkt += 1
                n_pts += len(pts)
                if self.csv_fn:
                    rows.append(pts)
                if self.max_packets and n_pkt >= self.max_packets:
                    break
        if self.csv_fn and rows:
            import numpy as np
            allp = np.concatenate(rows)
            with open(self.out_path(self.csv_fn), "w") as f:
                for x, y, z, r in allp:
                    f.write(f"{x:.4f},{y:.4f},{z:.4f},{int(r)}\n")
        print(f"velo_scan: {n_pkt} packets, {n_pts} points")
