"""Two coordinated processes through the port's ``torch.distributed``
helpers: the counterpart of tests/test_multihost.py.

Each process (this file run as a script, gloo on the CPU) brings up the
group with ``init_distributed``, sums its half of 0..15 over a local mesh
of four CPU slots (``psum``) and then across the processes
(``all_reduce``): 120 on both; then host 0's job-registry update reaches
both through ``broadcast_json_from_host0``. The parent asserts both agree.
"""

from __future__ import annotations

import json
import os
import pathlib
import socket
import subprocess
import sys

REPO = str(pathlib.Path(__file__).resolve().parents[1])
JOB = {"job_id": "abc-123", "status": "completed", "progress": 100}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_sum_and_registry_broadcast():
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen([sys.executable, __file__, str(rank), str(port)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for rank in (0, 1)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, f"worker failed:\n{err[-2000:]}"
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert [o["rank"] for o in outs] == [0, 1]
    for o in outs:
        assert o["world"] == 2 and o["backend"] == "gloo"
        assert o["local"] == [28.0, 92.0][o["rank"]]  # 0..7 and 8..15
        assert o["total"] == 120.0
        assert o["job"] == JOB


def _worker(rank: int, port: int) -> None:
    import torch
    import torch.distributed as dist

    from image_to_pointcloud_tpu_torch.parallel.sharding import (
        broadcast_json_from_host0,
        init_distributed,
        make_mesh,
        psum,
    )

    init_distributed(device="cpu", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                     rank=rank)
    try:
        mesh = make_mesh(data=4, devices=[torch.device("cpu")] * 4)
        rows = torch.arange(16.0).reshape(8, 2)[rank * 4 : rank * 4 + 4]
        local = psum([r.sum() for r in rows])[0]  # one row per data slot
        total = local.clone()
        dist.all_reduce(total)
        job = broadcast_json_from_host0(JOB if rank == 0 else None)
        print(json.dumps({"rank": rank, "world": dist.get_world_size(),
                          "backend": dist.get_backend(), "slots": mesh.size,
                          "local": float(local), "total": float(total), "job": job}),
              flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]))
