"""``dense`` executor: every expert on every token, combined with a
routing mask (counterpart of ``repro.execution.dense``).

The paper's "PyTorch reference" baseline: O(T*E*ffn) compute in fp32,
exact semantics, the correctness ground truth of the tests and the slow
arm of the paper's Tables 2-4.  It consumes only ``plan.weights`` and
``plan.indices``: there is no permuted layout, so its plans carry no
schedule (``needs_schedule = False``) and it has no phase methods (the EP
paths need ``blocks`` or ``cuda``).  Quantized expert stacks are
materialized up front by the base ``prepare_weights``.  Plain PyTorch, as
the reference's is plain jnp: it launches none of the port's kernels."""
from __future__ import annotations

from repro_torch.execution.base import (DispatchPlan, Executor,
                                        register_executor)
from repro_torch.kernels import ref


@register_executor("dense")
class DenseExecutor(Executor):
    needs_schedule = False

    def run(self, x, w, plan: DispatchPlan, cfg):
        w = self.prepare_weights(w, cfg)
        return ref.moe_ffn_dense_ref(x, w["w_gate"], w["w_up"], w["w_down"],
                                     plan.weights, plan.indices)
