"""PyTorch + CUDA port of the diBELLA 2D assembly pipeline (``repro``).

The single-device main path of ``repro.assembly.pipeline.assemble`` —
CountKmer → CreateSpMat → SpGEMM → Alignment → BuildR → TrReduction →
Contigs → Consensus — on torch tensors, with the JAX package's three
Pallas kernels on that path (x-drop, min-plus, pileup) rewritten as
hand-written CUDA kernels for Hopper (``csrc/``).  The package never
imports ``jax`` or ``repro``; ``convert.py`` carries data and config
across for the parity tests.

Entry point: :func:`repro_torch.assembly.pipeline.assemble`, which runs on
the card unless ``PipelineConfig(device="cpu")``.  Beside it,
``repro_torch.models`` and ``python -m repro_torch.launch.serve`` serve
the ten language-model archs of ``repro.configs`` on one device (torch
ops: JAX's LM path reaches no Pallas kernel).
"""
