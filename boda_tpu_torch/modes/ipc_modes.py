"""Remote-execution modes: the IPC worker and master/worker smoke tests.

Counterpart of ``boda_tpu/modes/ipc_modes.py``. Parity targets:
``ipc_compute_worker`` (ref src/rtc_ipc.cc:333), ``cs_test_master`` /
``cs_test_worker`` (ref src/rtc_ipc.cc:290,:313 — the documented manual
multi-process test procedure over all transports). The worker's backend
defaults to the card (``be=cuda``).
"""

from __future__ import annotations

from ..config import Field, Mode, register
from ..rtc.ipc import worker_loop
from ..rtc.stream_util import make_stream


@register("mode", "ipc_compute_worker", help="serve backend RPCs over a transport")
class IpcComputeWorker(Mode):
    addr = Field(str, req=True, help="transport: fds:R:W | fns:A:B | tcp:host:port")
    listen = Field(bool, default="0", help="listen (tcp server) instead of connect")

    def main(self) -> None:
        stream = make_stream(self.addr, listen=self.listen)
        worker_loop(stream)


@register("mode", "cs_test_master", help="IPC smoke test: run rtc_test via a worker")
class CsTestMaster(Mode):
    addr = Field(str, default="", help="worker addr ('' = spawn child)")
    worker_be = Field("lexp", default="(be=cuda)", help="worker-side backend")
    n = Field(int, default="10000", help="vector length")

    def main(self) -> None:
        from ..config import make
        from .rtc import RtcTest
        be = make("be", "ipc", addr=self.addr, worker_be=self.worker_be)
        t = RtcTest.__new__(RtcTest)
        t.boda_output_dir = self.boda_output_dir
        t.be = be
        t.n = self.n
        try:
            t.main()
        finally:
            be.shutdown()


@register("mode", "cs_test_worker", help="IPC smoke test: the worker side (tcp listen)")
class CsTestWorker(Mode):
    port = Field(int, default="12791", help="tcp port to listen on")

    def main(self) -> None:
        stream = make_stream(f"tcp:127.0.0.1:{self.port}", listen=True)
        worker_loop(stream)
