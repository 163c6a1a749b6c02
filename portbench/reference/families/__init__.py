"""The model families of the reference, one module each, found by the name
a configuration gives in ``arch.family`` (:func:`portbench.reference.model.family`).

A family module imports nothing of the port and no JAX, and provides:

* ``param_specs(arch)`` → ``[(name, shape, init kind, fan-in)]``, every
  parameter of the served model under its served name, in the order
  ``portbench/weights.py`` draws them (kinds: ``lecun``, ``lecun_abs``,
  ``zeros``, ``ones``, ``normal``, and ``softplus_ramp``, whose fan-in
  slot holds the (low, high) ends of the ramp its softplus makes);
* ``forward(sd, arch, pixels, *, fp8=False)``: (B, mh, mw, 3) model input
  → (B, oh, ow) f32 depth, TF32 off by the caller; ``fp8=True`` is the
  control (every matrix product in float8 e4m3,
  :class:`portbench.reference.vit_dpt.Ops`);
* ``model_input(image, cfg)``: an (H, W, 3) f32 upload in [0, 255] on the
  reference's device → the (mh, mw, 3) model input (resize, padding,
  normalization);
* ``model_output(depth, cfg, h, w)``: the model's (oh, ow) depth → the
  depth the shared tail of :func:`portbench.reference.pipeline.reference_cloud`
  resizes to (h, w) and normalizes inverted (a crop or a resize back,
  where the input handling padded);
* ``model_target(cfg)``: what the port's ``ModelManager(model_target=…)``
  takes, an int or an (h, w) pair;
* ``model_grid(cfg, h, w)``: the patch grid an (h, w) upload reaches the
  encoder at;
* ``flops_per_image(cfg, h, w)``: the model's FLOPs an (h, w) upload, by
  the conventions of ``portbench/flops.py``;
* ``port_fields(cfg)`` → ``[(path, value)]``: what the state dict's shapes
  do not show (taps, norm epsilon, windows, bin settings, the processor's
  constants), each as a dotted attribute path on the port's preset config
  (``preset(cfg["preset"])``) and the value the configuration gives it; a
  sequence compares as a tuple. ``portbench/tests`` checks every pair, and
  the served state dict against ``param_specs`` name for name and shape
  for shape.
"""
