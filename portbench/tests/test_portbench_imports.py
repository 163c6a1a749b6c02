"""By the top-level name of every module in ``sys.modules``, compared
whole: the harness never loads ``jax``, ``jaxlib``, ``flax`` or the JAX
package, and the reference loads none of the port either."""

import json
import subprocess
import sys

from portbench import spec
from portbench.run import FORBIDDEN, loaded_forbidden

HARNESS = ["portbench.run", "portbench.calibrate", "portbench.drivers.serve", "portbench.drivers.bulk",
           "portbench.drivers.serve_child", "portbench.weights", "portbench.tracing", "portbench.compare",
           "portbench.knee"]


def _top_level_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))"],
                         cwd=spec.ROOT, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_harness_loads_no_jax():
    readers = "".join(f"spec.metric_reader({m['name']!r})\n" for m in spec.benchmark()["per_layer"])
    code = "".join(f"import {m}\n" for m in HARNESS) + "from portbench import spec\n" + readers
    # The port as the harness drives it: its server, pipeline and models.
    code += ("import image_to_pointcloud_tpu_torch.serve.app_v1, image_to_pointcloud_tpu_torch.serve.http\n"
             "import image_to_pointcloud_tpu_torch.pipeline.graph\n")
    names = _top_level_after(code)
    assert not names & set(FORBIDDEN), names & set(FORBIDDEN)
    assert "image_to_pointcloud_tpu_torch" in names  # the comparison is of whole names


def test_reference_loads_none_of_the_program():
    names = _top_level_after("import portbench.reference.pipeline, portbench.reference.model, "
                             "portbench.reference.ops, portbench.compare")
    assert not names & {*FORBIDDEN, "image_to_pointcloud_tpu_torch"}


def test_whole_name_comparison(monkeypatch):
    monkeypatch.setitem(sys.modules, "image_to_pointcloud_tpu_torch_fake", sys)
    assert "image_to_pointcloud_tpu" not in loaded_forbidden()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in loaded_forbidden()
