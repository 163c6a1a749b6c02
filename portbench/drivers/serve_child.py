"""The server under test, in a process of its own: the port's v1 service
(``serve/app_v1.V1Service`` behind ``serve/http.HttpServer``) at the
cell's settings, its model's weights made on the card from the seed, its
warmup run before the socket opens.

``python -m portbench.drivers.serve_child '<json>'`` prints one line,
``{"port": <bound port>, "build_s": …, "warmup_s": …}``, once it
listens, and serves until SIGTERM. Beside the v1 routes it answers
``GET /portbench/state`` with the process's peak of allocated device
memory and the names of :data:`portbench.run.FORBIDDEN` in its
``sys.modules``, which the harness reads once the window has closed.
"""

from __future__ import annotations

import asyncio
import json
import os
import signal
import sys
import time


def main() -> None:
    params = json.loads(sys.argv[1])
    import torch

    from portbench.weights import make_state_dict, seeded_manager

    cfg = json.loads(open(params["config"]).read())
    srv = params["server"]
    device = params.get("device", "cuda")
    cuda = device == "cuda"
    from portbench.drivers import build_program

    build_s = build_program() if cuda else 0.0

    from image_to_pointcloud_tpu_torch.serve.app_v1 import create_v1_app
    from image_to_pointcloud_tpu_torch.serve.http import HttpServer, json_response

    # The served dtype on the card; f32 on the CPU, as the port serves there.
    dtype = getattr(torch, cfg["dtype"]) if cuda else torch.float32
    sd = make_state_dict(cfg, params["seed"], device, dtype)
    app = create_v1_app(
        output_dir=params["out_dir"],
        models=seeded_manager(sd, device, model_target=cfg["preprocess"]["target"]),
        warmup_sizes=[tuple(s) for s in srv["warmup"]],
        batch_window_ms=srv["batch_window_ms"],
        max_batch=srv["max_batch"],
        jpeg_device_decode=srv["jpeg_device_decode"],
        lazy_export=srv["lazy_export"],
    )
    t1 = time.perf_counter()
    app.warmup(cfg["preset"])
    if cuda:
        torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t1

    from portbench.run import loaded_forbidden

    @app.router.get("/portbench/state")
    async def state(req):
        return json_response({"peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0,
                              "loaded": loaded_forbidden()})

    async def serve() -> None:
        server = HttpServer(app.router, "127.0.0.1", 0)
        await server.start()
        # Ended by the harness; the point clouds left unexported are of no
        # use to it, so no graceful drain.
        asyncio.get_running_loop().add_signal_handler(signal.SIGTERM, os._exit, 0)
        print(json.dumps({"port": server.bound_port, "build_s": build_s, "warmup_s": warmup_s}),
              flush=True)
        await server.serve_forever()

    asyncio.run(serve())


if __name__ == "__main__":
    main()
