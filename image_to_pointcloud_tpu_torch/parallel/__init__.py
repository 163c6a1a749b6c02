"""Parallel execution on a mesh of device slots, driven by one process:
the (data, model, seq) mesh, megatron TP and the collectives
(``sharding.py``), sequence and ring attention (``context.py``), GPipe
over a (data, pipe) mesh (``pipeline_par.py``), and high-resolution
tiling (``tiling.py``)."""
