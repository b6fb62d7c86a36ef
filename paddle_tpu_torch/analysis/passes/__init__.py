"""Program-IR optimization passes ahead of the run.

The JAX package's pipeline on the port's IR: a pass is a Python rewrite
over a verified clone of the Program, gated by FLAGS_graph_opt_level.
The optimized program is the JAX package's to the byte (folded
transcendental values within the bound stated in constant_fold.py):

  0 — off: run the program exactly as built.
  1 — default: dead-op elimination (the PTV012 walk as a rewrite),
      constant folding (registered lowerings evaluated on the CPU), CSE
      (value numbering on (op_type, attrs, input versions)).
  2 — adds elementwise-chain fusion (consecutive chains merge into one
      fused_elementwise op replaying the originals bit-exactly, with a
      shared profiler-scope label as the fallback), buffer reuse
      (liveness intervals from analysis/memory.py → disjoint same-spec
      transients renamed onto one buffer, after the in-place state
      updates are sunk; FLAGS_buffer_reuse), and the donation plan
      (PTV015 alias analysis → the hazard-free optimizer state). The
      port's updates already run in place, so the executor reads no
      donation plan; the plan and its stats are kept for parity.

Every rewrite must preserve bit-exact observable outputs
(tests/test_torch_graph_passes.py), and the optimized program must
re-verify clean with error semantics before it replaces the original.
Pipeline runs are memoized per (fingerprint, level, feeds, fetches) —
optimize_gate — and surface as analysis.pass_* monitor stats.

A forward op that a ``grad::generic`` op names leaves an autograd record
under its id when it runs (core/lowering.py); the passes keep every such
record reachable. Fusion keeps each sub-op's id in ``sub_ops``, and the
fused lowering records under it. CSE records the ids it merges in
``program._record_alias`` (dropped id -> survivor id), and the executor
reads the survivor's record once per grad op that names either.
"""
from .base import (Pass, PassContext, PassManager, default_passes,
                   optimize_gate, optimize_program, reset_memo)
from .constant_fold import FOLDABLE_OPS, ConstantFolding
from .cse import CommonSubexprElimination
from .dce import DeadOpElimination
from .donation import DonationPlanner
from .fusion import FUSABLE_OPS, ElementwiseFusionScopes
from .reuse import BufferReuse

__all__ = [
    "Pass", "PassContext", "PassManager", "default_passes",
    "optimize_program", "optimize_gate", "reset_memo",
    "DeadOpElimination", "ConstantFolding", "CommonSubexprElimination",
    "ElementwiseFusionScopes", "BufferReuse", "DonationPlanner",
    "FOLDABLE_OPS", "FUSABLE_OPS",
]
