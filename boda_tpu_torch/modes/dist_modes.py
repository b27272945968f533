"""Multi-process (multi-controller) data-parallel training test modes.

Counterpart of ``boda_tpu/modes/dist_modes.py`` (ref ``cs_test_master`` /
``cs_test_worker``, src/rtc_ipc.cc:290,:313). boda_tpu forms one JAX cluster
out of N controller processes (``jax.distributed``), each with
``devices_per_proc`` virtual CPU devices, and runs its dp-sharded GSPMD step
over the cluster's mesh. The port's ranks join one ``torch.distributed``
process group and run parallel/train.py's step with that ``group``.

``dist_test_master`` spawns ``num_procs`` ``python -m boda_tpu_torch
dist_test_worker`` processes (the repo root on PYTHONPATH, the device count
per process in ``XLA_FLAGS`` as for boda_tpu's workers) and checks that
every rank computed the same decreasing global loss, and the same bits of
its losses, weights and momenta (a digest each worker prints).

Each worker holds the same global batch, 2 images per device, made from
``--seed``, and steps its process-local slice: the slice of its
``devices_per_proc`` logical devices, all on the rank's one device, as
boda_tpu's virtual CPU devices share one CPU. ``--device=cpu``: gloo and the
kernels' plain versions. ``--device=cuda`` (the default): rank r on
``cuda:(r % device_count)``, over NCCL when every rank has a card of its
own, else over gloo on the CUDA tensors (ranks sharing a card: NCCL refuses
two ranks on one device); the worker prints which. Over NCCL the step is
compiled (``--cuda-graph``, default 1: captured once as one CUDA graph with
its all-reduces and replayed, as boda_tpu jits its sharded step); over gloo
it runs eagerly; the worker prints the step's line saying which.
"""

from __future__ import annotations

import os
import re
import socket
import subprocess
import sys

from ..config import Field, Mode, register


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def dist_backend(device: str, num_procs: int) -> str:
    """gloo on the CPU; on the card NCCL when every rank has a card of its
    own, else gloo (on the CUDA tensors)."""
    import torch
    if device == "cpu":
        return "gloo"
    return "nccl" if num_procs <= torch.cuda.device_count() else "gloo"


def rank_device(device: str, rank: int):
    """The device of a rank: the CPU, or ``cuda:(rank % device_count)``."""
    import torch

    from ..parallel.train import train_device
    d = train_device(device, "dist_test_worker")
    return d if d.type == "cpu" else torch.device("cuda", rank % torch.cuda.device_count())


@register("mode", "dist_test_worker",
          help="one controller process of a multi-controller distributed run")
class DistTestWorker(Mode):
    coord = Field(str, req=True, help="coordinator address host:port")
    num_procs = Field(int, default="2", help="total controller processes")
    process_id = Field(int, req=True, help="this process's rank")
    steps = Field(int, default="3", help="training steps to run")
    seed = Field(int, default="0", help="data/init seed (same on all ranks)")
    model = Field(str, default="mini_resnet",
                  help="zoo model for the sharded step (e.g. resnet50 for "
                       "the flagship-class cross-controller run)")
    in_sz = Field(int, default="16", help="input size")
    num_cls = Field(int, default="16", help="classes (head width)")
    device = Field(str, default="cuda",
                   help="cuda (the card; raises without one) | cpu (gloo, plain versions)")
    cuda_graph = Field(bool, default="1",
                       help="on the card over NCCL: the step captured once as one CUDA graph "
                            "and replayed (0 = eager, launch by launch)")

    def main(self) -> None:
        import hashlib
        import time

        import numpy as np
        import torch
        import torch.distributed as dist

        from ..models.zoo import build_model
        from ..parallel.mesh import cpu_device_count
        from ..parallel.train import find_logits_node, make_train_step

        dev = rank_device(self.device, self.process_id)
        backend = dist_backend(self.device, self.num_procs)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"tcp://{self.coord}",
                                world_size=self.num_procs, rank=self.process_id)
        step = None
        try:
            n_dev = self.num_procs * cpu_device_count()
            img = 2 * n_dev  # global batch; 2 per device
            pipe, in_dims = build_model(self.model, img=img, num_cls=self.num_cls,
                                        in_sz=self.in_sz)
            # resnet50-class runs use the flagship step config (remat=seg, as
            # boda_tpu's worker and dryrun). The compiled step, as boda_tpu's
            # worker jits its sharded step: captured over NCCL on the card;
            # over gloo (ranks sharing a card) it runs eagerly, and the line
            # printed below says why
            step = make_train_step(pipe, find_logits_node(pipe), lr=0.05, momentum=0.9,
                                   bn_momentum=0.1, clip_norm=1.0,
                                   remat="seg" if self.model != "mini_resnet" else "",
                                   group=dist.group.WORLD, cuda_graph=self.cuda_graph)
            # identical global data on every rank (same seed); each rank steps
            # its process-local slice
            rng = np.random.RandomState(self.seed)
            x_all = rng.randn(*in_dims["data"].shape).astype(np.float32)
            y_all = rng.randint(0, self.num_cls, size=(img,)).astype(np.int32)
            per = img // self.num_procs
            lo = per * self.process_id
            x = torch.from_numpy(x_all[lo:lo + per]).to(dev)
            y = torch.from_numpy(y_all[lo:lo + per]).to(dev)
            weights = {k: torch.from_numpy(np.ascontiguousarray(w.data)).to(dev)
                       for k, w in pipe.weights.items()}
            mom, losses, secs = None, [], []
            for _ in range(self.steps):
                t0 = time.perf_counter()
                loss, weights, mom = step(weights, {"data": x}, y, mom)
                losses.append(float(loss))  # a sync: the step's time ends here
                secs.append(time.perf_counter() - t0)
            # the bits of the losses, weights and momenta, for the master
            h = hashlib.sha256(np.array(losses, np.float32).tobytes())
            for d in (weights, mom):
                for k in sorted(d):
                    h.update(d[k].cpu().numpy().tobytes())
            print(f"dist_test_worker rank={self.process_id} backend={backend} device={dev} "
                  f"ms_per_step=" + ",".join(f"{s * 1e3:.3f}" for s in secs)
                  + f" digest={h.hexdigest()[:16]}")
            for ln in step.info_log:
                if ln.startswith(("eager", "captured")):
                    print(f"dist_test_worker rank={self.process_id} step: {ln}")
            print(f"dist_test_worker rank={self.process_id} ndev={n_dev} "
                  "losses=" + ",".join(f"{v:.6f}" for v in losses))
        finally:
            if step is not None:  # NCCL's teardown waits for the graph that holds its kernels
                step.release()
            dist.destroy_process_group()


@register("mode", "dist_test_master",
          help="spawn + verify a multi-controller (2-process) distributed run")
class DistTestMaster(Mode):
    num_procs = Field(int, default="2", help="controller processes to spawn")
    devices_per_proc = Field(int, default="2", help="virtual CPU devices each")
    steps = Field(int, default="3", help="training steps")
    port = Field(int, default="0", help="coordinator port (0 = pick free)")
    model = Field(str, default="mini_resnet", help="zoo model (see worker)")
    in_sz = Field(int, default="16", help="input size")
    num_cls = Field(int, default="16", help="classes")
    device = Field(str, default="cuda",
                   help="the workers' device: cuda (the card; raises without one) | "
                        "cpu (gloo, plain versions)")
    cuda_graph = Field(bool, default="1", help="the workers' cuda_graph (see worker)")

    def main(self) -> None:
        port = self.port or _free_port()
        coord = f"localhost:{port}"
        # the child imports this package from wherever the master runs
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (root, os.environ.get("PYTHONPATH", "")) if p))
        flags = [f for f in env.get("XLA_FLAGS", "").split()
                 if not f.startswith("--xla_force_host_platform_device_count")]
        flags.append("--xla_force_host_platform_device_count="
                     f"{self.devices_per_proc}")
        env["XLA_FLAGS"] = " ".join(flags)
        procs = []
        for rank in range(self.num_procs):
            cmd = [sys.executable, "-m", "boda_tpu_torch", "dist_test_worker",
                   f"--coord={coord}", f"--num-procs={self.num_procs}",
                   f"--process-id={rank}", f"--steps={self.steps}",
                   f"--model={self.model}", f"--in-sz={self.in_sz}",
                   f"--num-cls={self.num_cls}", f"--device={self.device}",
                   f"--cuda-graph={int(self.cuda_graph)}"]
            procs.append(subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True, cwd=root))
        outs = []
        fail = False
        try:
            for rank, p in enumerate(procs):
                out, _ = p.communicate(timeout=600)
                outs.append(out)
                if p.returncode != 0:
                    fail = True
                    print(f"rank {rank} FAILED rc={p.returncode}:\n{out[-2000:]}")
        finally:
            for p in procs:  # the others, where one rank's wait timed out
                if p.poll() is None:
                    p.kill()
        if fail:
            raise RuntimeError("dist_test_master: worker process failed")
        # every rank must report the SAME decreasing global loss sequence
        # (and, in the port, the same bits of its losses, weights and momenta)
        seqs, digests = [], []
        for rank, out in enumerate(outs):
            m = re.search(rf"dist_test_worker rank={rank} ndev=(\d+) "
                          r"losses=([\d.,-]+)", out)
            if not m:
                raise RuntimeError(
                    f"dist_test_master: rank {rank} printed no result:\n"
                    f"{out[-2000:]}")
            n_dev = int(m.group(1))
            seqs.append([float(v) for v in m.group(2).split(",")])
            digests.append(re.search(rf"rank={rank} .* digest=(\w+)", out).group(1))
            for ln in out.splitlines():
                if ln.startswith(f"dist_test_worker rank={rank} "):
                    print(ln)
        want_dev = self.num_procs * self.devices_per_proc
        if n_dev != want_dev:
            raise RuntimeError(f"cluster saw {n_dev} devices, want {want_dev}")
        for rank in range(1, self.num_procs):
            if seqs[rank] != seqs[0]:
                raise RuntimeError(
                    f"rank {rank} loss sequence {seqs[rank]} != rank 0 "
                    f"{seqs[0]} (SPMD determinism broken)")
            if digests[rank] != digests[0]:
                raise RuntimeError(f"rank {rank}'s losses, weights and momenta differ in "
                                   f"their bits from rank 0's (SPMD determinism broken)")
        if not seqs[0][-1] < seqs[0][0]:
            raise RuntimeError(f"loss did not decrease: {seqs[0]}")
        print(f"dist_test_master: {self.num_procs} controllers x "
              f"{self.devices_per_proc} devices, loss "
              f"{seqs[0][0]:.4f} -> {seqs[0][-1]:.4f}, all ranks agree OK")
