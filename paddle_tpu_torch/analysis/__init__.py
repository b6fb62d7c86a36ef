"""Static program analysis: shape/dtype inference, graph lints, the
memory planner and the graph passes, with no device work.

The JAX package's ``analysis`` package on the port's IR and lowerings:

- `shape_infer`: propagate (shape, dtype) through every op by running its
  registered lowering on ``meta`` tensors (shapes and dtypes only, no
  data and no kernel), once per (program fingerprint, feed signature);
  the verifier and the memory planner share the result.
- `verifier`: dataflow lints (use before def, dead ops, write after
  write, inplace aliasing hazards, sub-block consistency, registry and
  version checks) and the executor's and the serving engine's gate,
  driven by FLAGS_program_verify=off|warn|error.
- `memory`: the static memory planner (liveness intervals over the
  global block, a per-op resident-bytes timeline, a peak estimate) and
  the FLAGS_memory_gate gate (PTV050/051/052) that refuses a program
  over the card's memory before its first run.
- `passes`: the FLAGS_graph_opt_level pipeline.
- `sharding`: SpecLayout propagation, the collective cost model
  (`collective_bytes_per_step`) and the FLAGS_sharding_verify gate
  (PTV060-063), in the executor and the serving engine.

Every diagnostic carries a stable rule ID (PTVnnn), a severity, and
provenance in the "{op_type}:{block}/{op_idx}" format of the op trace
scopes, so a finding and a profiler row name the same op. The rule IDs,
severities and messages are the JAX package's.
"""
from .diagnostics import (Diagnostic, ProgramVerificationError, RULES,
                          VerifyResult)
from .memory import analyze_program_memory, memory_gate
from .passes import optimize_gate
from .sharding import (ShardingReport, analyze_program_sharding,
                       sharding_gate)
from .verifier import verify_gate, verify_program

__all__ = ["Diagnostic", "VerifyResult", "ProgramVerificationError",
           "RULES", "verify_program", "verify_gate", "optimize_gate",
           "memory_gate", "analyze_program_memory", "ShardingReport",
           "analyze_program_sharding", "sharding_gate"]
