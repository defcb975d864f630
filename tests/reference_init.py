"""Random weights in the reference's parameter tree for the port's CPU
tests, drawn with numpy: cheaper than the reference's ``init_params``,
whose every op compiles on first use.  Imports JAX (the reference side of
a test, never a rank body)."""
import jax
import numpy as np

from repro.models.lm import init_params as jax_init_params

# the constant leaves' init values (noise of 0.2 is added to each; a
# layernorm's scale, beside its bias, starts at 1, an RMSNorm's at 0: its
# (1 + scale) form), and the matrices whose init scale is not fan-in's
CONSTANTS = {"mu": 0.5, "w0": -1.0, "d_skip": 1.0}
SCALES = {"embed": 0.02, "w_lora_b": 0.01, "conv_w": 0.1}


def numpy_init(jcfg, seed: int) -> dict:
    """The reference's parameter tree (``jax.eval_shape`` of its
    ``init_params``) filled with numpy draws: each leaf of two dims or
    more normal at its init's scale (fan-in's, or ``SCALES``), each vector
    its init constant (``CONSTANTS``, a norm's scale, else 0) plus N(0,
    0.2), ``a_log`` the log of its 1..16 ramp plus the same.  Returns numpy
    leaves."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jax_init_params(jcfg, jax.random.key(0)))

    def leaf(name: str, sd, stacked: bool, siblings) -> np.ndarray:
        core = sd.shape[int(stacked):]
        noise = rng.standard_normal(sd.shape).astype(np.float32)
        if len(core) >= 2:
            return noise * np.float32(SCALES.get(name, core[-2] ** -0.5))
        base = CONSTANTS.get(name, 0.0)
        if name == "scale" and "bias" in siblings:     # a layernorm's
            base = 1.0
        if name == "a_log":
            base = np.log(np.linspace(1.0, 16.0, core[-1])).astype(
                np.float32)
        return base + noise * np.float32(0.2)

    def walk(node, stacked: bool):
        if isinstance(node, list):
            return [walk(v, stacked) for v in node]
        return {k: (walk(v, stacked) if isinstance(v, (dict, list))
                    else leaf(k, v, stacked, node))
                for k, v in node.items()}
    return {k: (walk(v, k in ("body", "shared"))
                if isinstance(v, (dict, list)) else leaf(k, v, False, shapes))
            for k, v in shapes.items()}
