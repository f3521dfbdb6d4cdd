"""dart_tpu — an RNA-seq spliced short-read aligner on JAX.

A from-scratch rebuild of the capabilities of Dart (Lin & Hsu, 2018;
reference C++ implementation surveyed in SURVEY.md) with its seeding
on an accelerator (an NVIDIA GPU; the CPU backend runs the same code):

- FM-index seeding and suffix-array location run as batched,
  gather-heavy JAX programs over a device-resident index
  (``dart_tpu.ops``).
- Gap closing uses a Needleman-Wunsch DP with the reference's exact
  scoring semantics, in host C++ (``dart_tpu.native``) with a NumPy
  twin (``dart_tpu.ops.nw_numpy``).
- Chaining and alignment finalization (the divide-and-conquer candidate
  pipeline) live in ``dart_tpu.pipeline``.
- Index construction/loading with BWA-compatible on-disk formats plus
  the device layouts lives in ``dart_tpu.index``.
- Reads stream data-parallel over a ``jax.sharding.Mesh`` or over
  ``jax.distributed`` processes (``dart_tpu.parallel``); splice-junction
  tables and counters merge via collectives.
"""

__version__ = "0.1.0"
