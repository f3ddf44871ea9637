"""JAX witness generator: evaluates a CompiledPlan on device.

The device half of the static-template design (SURVEY.md §2b ark-relations row):
the circuit template records one fused bit-evaluation record per witness;
here the levels are padded to a rectangle and driven by ONE lax.scan whose
body does gather -> fused int32 multiply-add -> scatter, so the traced graph
is O(1) in circuit depth and the whole witness fill is a single compiled
program (~10^5 bits in a few ms).
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from ..models.witness_plan import CompiledPlan
from ..utils.config import init_jax_compilation_cache

init_jax_compilation_cache()


class WitnessEvaluator:
    """Compiled, jittable witness evaluation for one circuit template."""

    def __init__(self, plan: CompiledPlan):
        self.plan = plan
        self.num_vars = plan.num_vars
        max_m = max((lvl.out.shape[0] for lvl in plan.levels), default=1)
        n_lvl = len(plan.levels)
        # pad every level to max_m; dummy records write to a dump slot
        dump = plan.num_vars
        out = np.full((n_lvl, max_m), dump, np.int32)
        xyz = np.zeros((3, n_lvl, max_m), np.int32)
        coeffs = np.zeros((n_lvl, 7, max_m), np.int32)
        for i, lvl in enumerate(plan.levels):
            m = lvl.out.shape[0]
            out[i, :m] = lvl.out
            xyz[0, i, :m] = lvl.x
            xyz[1, i, :m] = lvl.y
            xyz[2, i, :m] = lvl.s
            coeffs[i, :, :m] = lvl.coeffs
        # HOST numpy on purpose: these close over the jitted evaluator as
        # constants, and numpy constants lower from host memory — a
        # committed device array here would be fetched back from the
        # device during every lowering.
        self._out = out
        self._x = xyz[0]
        self._y = xyz[1]
        self._s = xyz[2]
        self._coeffs = coeffs
        self._inputs = {
            k: (np.asarray(plan.input_idx[k]), np.asarray(plan.input_slot[k]))
            for k in plan.input_idx
        }
        self._inst = (
            np.asarray(plan.inst_idx),
            np.asarray(plan.inst_c),
            np.asarray(plan.inst_var),
            np.asarray(plan.inst_q),
        )
        self.evaluate = jax.jit(self._evaluate)

    def _evaluate(self, inputs: Dict[str, jnp.ndarray]) -> jnp.ndarray:
        """inputs: source -> flat 0/1 int32 bit tensors. Returns z [num_vars+1]
        int32 (the final dump slot is stripped by callers via [:num_vars])."""
        z = jnp.zeros(self.num_vars + 1, jnp.int32)
        z = z.at[0].set(1)
        for name, (idx, slot) in self._inputs.items():
            z = z.at[idx].set(inputs[name][slot])

        def body(z, lvl):
            out_i, x_i, y_i, s_i, c = lvl
            x = z[x_i]
            y = z[y_i]
            s = z[s_i]
            val = (
                c[0]
                + c[1] * x
                + c[2] * y
                + c[3] * s
                + c[4] * x * y
                + c[5] * s * x
                + c[6] * s * y
            )
            return z.at[out_i].set(val), None

        z, _ = jax.lax.scan(
            body, z, (self._out, self._x, self._y, self._s, self._coeffs)
        )
        inst_idx, inst_c, inst_var, inst_q = self._inst
        z = z.at[inst_idx].set(inst_c + inst_q * z[inst_var])
        return z[: self.num_vars]


def evaluator_for(plan: CompiledPlan) -> WitnessEvaluator:
    ev = getattr(plan, "_jax_evaluator", None)
    if ev is None:
        ev = WitnessEvaluator(plan)
        plan._jax_evaluator = ev
    return ev
