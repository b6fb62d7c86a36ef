"""Collective transpilers: rewrite a single-process program for
multi-process data parallelism.

Reference: python/paddle/fluid/transpiler/collective.py — `Collective`
inserts c_gen_nccl_id + c_comm_init into the startup program (:113-123);
`GradAllReduce` (:178) appends c_allreduce_sum after each gradient with
multi-ring round-robin (:240-247) and scales by 1/nranks; `LocalSGD`
(:269) replaces per-step grad allreduce with periodic parameter averaging.

The port emits the JAX package's ops in the same places. There is no
NCCL-id handshake: the torch.distributed process group is the bootstrap
(distributed/env.init_parallel_env), so comm init is the
`c_comm_init_all` marker op, which does nothing. Each process is one
rank, as in the reference, so at world N the inserted scale +
c_allreduce_sum really average the gradients over the ranks
(ops/collective.py); at one rank they are the identity, as in the JAX
package. ring_id round-robin maps rings to mesh axes
(parallel/mesh.axis_for_ring).
"""
from __future__ import annotations

from .util import optimize_ops as _optimize_ops

__all__ = ["Collective", "GradAllReduce", "LocalSGD"]

OpRole = type("OpRole", (), {"Forward": 0, "Backward": 1, "Optimize": 2})


class Collective:
    """Base: records job topology, rewrites startup with comm init."""

    def __init__(self, nrings=1):
        self.nrings = nrings
        self.nranks = 0
        self.rank = 0

    def transpile(self, startup_program, main_program, rank, endpoints,
                  current_endpoint, wait_port=True):
        if isinstance(endpoints, str):
            endpoints = endpoints.split(",")
        self.nranks = len(endpoints)
        self.rank = rank
        self.startup_program = startup_program
        self.main_program = main_program
        self._transpile_startup_program(endpoints, current_endpoint)
        self._transpile_main_program()
        return self

    def _transpile_startup_program(self, endpoints, current_endpoint):
        # reference: c_gen_nccl_id (TCP bcast of the NCCL id,
        # c_gen_nccl_id_op.cc:68) + one c_comm_init per ring. Here the
        # marker op records topology; the process group comes from
        # distributed.launch/init_parallel_env.
        blk = self.startup_program.global_block()
        blk.append_op(
            "c_comm_init_all", inputs={}, outputs={},
            attrs={"endpoints": list(endpoints),
                   "current_endpoint": current_endpoint,
                   "rank": self.rank, "nranks": self.nranks,
                   "nrings": self.nrings},
            infer_shape=False)

    def _transpile_main_program(self):
        raise NotImplementedError


class GradAllReduce(Collective):
    """Insert allreduce-sum on every gradient (collective.py:178)."""

    def __init__(self, nrings=1):
        super().__init__(nrings)

    def _transpile_main_program(self):
        block = self.main_program.global_block()
        opt_ops = _optimize_ops(block)
        grads = []
        for op in opt_ops:
            grads.extend(op.inputs["Grad"])
        grads = [g for g in dict.fromkeys(grads) if g]
        if not grads:
            return

        # last producer index of each grad
        producer = {}
        for i, op in enumerate(block.ops):
            for n in op.output_names():
                if n in grads:
                    producer[n] = i

        first_opt = min(block.ops.index(op) for op in opt_ops)
        # walk in reverse so earlier insertions don't shift later indices
        ring = 0
        from ..framework import Operator
        for g in sorted(grads, key=lambda g: -producer.get(g, first_opt)):
            idx = producer.get(g, first_opt - 1) + 1
            scale_op = Operator(
                block, "scale", {"X": [g]}, {"Out": [g]},
                {"scale": 1.0 / self.nranks, "bias": 0.0})
            ar_op = Operator(
                block, "c_allreduce_sum", {"X": [g]}, {"Out": [g]},
                {"ring_id": ring % self.nrings})
            block.ops[idx:idx] = [scale_op, ar_op]
            ring += 1
        self.main_program._fp_cache = None


class LocalSGD(Collective):
    """Periodic parameter averaging instead of per-step grad allreduce
    (collective.py:269; fleet DistributedStrategy.use_local_sgd)."""

    def __init__(self, nrings=1, k_steps=1):
        super().__init__(nrings)
        self.k_steps = k_steps

    def _transpile_main_program(self):
        from ..layers.control_flow import _CondBlockGuard
        from ..layers.learning_rate_scheduler import every_n_steps
        from ..framework import program_guard, unique_name

        block = self.main_program.global_block()
        params = [op.inputs["Param"][0] for op in _optimize_ops(block)]
        params = list(dict.fromkeys(params))
        if not params:
            return
        with program_guard(self.main_program, self.startup_program):
            cond = every_n_steps(
                self.k_steps,
                counter_name=unique_name.generate("@LOCAL_SGD_STEP@"))
            with _CondBlockGuard(cond):
                sub = self.main_program.current_block()
                for ring, p in enumerate(params):
                    sub.append_op(
                        "c_allreduce_sum", inputs={"X": [p]},
                        outputs={"Out": [p]},
                        attrs={"ring_id": ring % self.nrings},
                        infer_shape=False)
                    sub.append_op(
                        "scale", inputs={"X": [p]}, outputs={"Out": [p]},
                        attrs={"scale": 1.0 / self.nranks, "bias": 0.0},
                        infer_shape=False)
