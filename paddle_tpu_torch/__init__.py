"""paddle_tpu_torch — the Fluid-style framework on PyTorch and CUDA.

The port of ``paddle_tpu`` (JAX/XLA/Pallas on a TPU) to an NVIDIA H100:
the same Program IR, op types and on-disk formats, lowered to PyTorch,
with the Pallas kernels rewritten as hand-written Hopper kernels
(``csrc/``). It imports torch, numpy and the standard library only.

Entry points run on the card unless the caller asks for the CPU
(``Executor(CPUPlace())``, ``AnalysisConfig.disable_gpu()``,
``dygraph.guard(CPUPlace())``).
"""
import torch as _torch

# Float32 matrix products stay exact (no TF32): served programs are
# float32, and parity with the JAX package's float32 results depends on
# full-precision products.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

# torch's CPU transcendental functions (sin, cos, exp, log, tanh, erf,
# sqrt, ...) call MKL's vector math, which sets up its CPU dispatch on its
# first call in a process. When that first call is split across intra-op
# threads, a thread can take another code path and return other last bits
# (a fresh process's first sin of a [129, 32] float32 tensor: 8 of 600
# differed), so a float32 program's CPU results would vary between runs.
# One call each on a single element sets the dispatch up on one thread.
for _fn in (_torch.sin, _torch.cos, _torch.tan, _torch.asin, _torch.acos,
            _torch.atan, _torch.sinh, _torch.cosh, _torch.tanh, _torch.exp,
            _torch.expm1, _torch.log, _torch.log2, _torch.log10,
            _torch.log1p, _torch.erf, _torch.erfc, _torch.sqrt,
            _torch.lgamma):
    for _dtype in (_torch.float32, _torch.float64):
        _fn(_torch.full((1,), 0.5, dtype=_dtype))
del _fn, _dtype

from . import ops  # noqa: F401,E402  — registers every op lowering
from .framework import (  # noqa: F401,E402
    Program, program_guard, default_main_program, default_startup_program,
    ParamAttr, WeightNormParamAttr, unique_name, Variable, Parameter,
    in_dygraph_mode, name_scope, cpu_places)
from .core.place import CPUPlace, CUDAPlace  # noqa: F401,E402
from .core.lod import LoDTensor, LoDTensorArray  # noqa: F401,E402
from .core.flags import FLAGS, get_flags, set_flags  # noqa: F401,E402
from .core.scope import Scope, global_scope, scope_guard  # noqa: F401,E402
from .executor import Executor  # noqa: F401,E402
from .compiler import (  # noqa: F401,E402
    BuildStrategy, CompiledProgram, ExecutionStrategy)
from . import compiler  # noqa: F401,E402
from . import analysis  # noqa: F401,E402
from . import layers  # noqa: F401,E402
from . import nets  # noqa: F401,E402
from . import initializer  # noqa: F401,E402
from . import io  # noqa: F401,E402
from . import io_sharded  # noqa: F401,E402
from .io_sharded import (save_sharded_persistables,  # noqa: F401,E402
                         load_sharded_persistables)
from . import inference  # noqa: F401,E402
from . import convert  # noqa: F401,E402
from . import backward  # noqa: F401,E402
from . import optimizer  # noqa: F401,E402
from . import regularizer  # noqa: F401,E402
from . import clip  # noqa: F401,E402
from . import average  # noqa: F401,E402
from .clip import set_gradient_clip  # noqa: F401,E402
from . import contrib  # noqa: F401,E402
from . import dygraph  # noqa: F401,E402
from . import distributed  # noqa: F401,E402
from . import parallel  # noqa: F401,E402
from . import transpiler  # noqa: F401,E402
from .parallel.api import ParallelExecutor  # noqa: F401,E402
from . import metrics  # noqa: F401,E402
from . import datasets  # noqa: F401,E402
from . import reader_decorator  # noqa: F401,E402
from .data_feeder import DataFeeder  # noqa: F401,E402
from .reader import DataLoader, PyReader  # noqa: F401,E402


def data(name, shape, dtype="float32", lod_level=0):
    """fluid.data: the batch dim is not prepended (the shape is the fed
    array's)."""
    return layers.data(name, shape, append_batch_size=False, dtype=dtype,
                       lod_level=lod_level)
