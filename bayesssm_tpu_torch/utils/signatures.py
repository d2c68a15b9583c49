"""User-function signature adaptation and validation (port of
``bayesssm_tpu/utils/signatures.py``).

Model functions declare only the arguments they use; the engine calls
every one of them with its full keyword set ``(key, particles, y, t,
num_particles, **theta)`` through :func:`adapt_fn`, which drops what the
signature does not declare. The messages are the JAX package's, which
are the reference's. :func:`adapt_move_fn` adapts the RMPF rejuvenation
move, which may be written for one particle.
"""

from __future__ import annotations

import inspect

import torch

from bayesssm_tpu_torch.ops import threefry

__all__ = ["ENGINE_ARGS", "adapt_fn", "adapt_move_fn", "check_params_match",
           "fn_param_names"]

# Engine-supplied argument names, never model parameters.
ENGINE_ARGS = frozenset({"num_particles", "particles", "particle", "y", "t",
                         "key"})


def fn_param_names(fn) -> tuple[set, bool]:
    """Names of explicit params, and whether the fn has a **kwargs catch-all."""
    names = set()
    has_var_kw = False
    for p in inspect.signature(fn).parameters.values():
        if p.kind == inspect.Parameter.VAR_KEYWORD:
            has_var_kw = True
        elif p.kind != inspect.Parameter.VAR_POSITIONAL:
            names.add(p.name)
    return names, has_var_kw


def adapt_fn(fn, fn_name: str, required: tuple = ()):
    """Wrap ``fn`` so it can be called with the engine's full keyword set;
    ``required`` names must be declared (or caught by ``**kwargs``)."""
    names, has_var_kw = fn_param_names(fn)
    for req in required:
        if req not in names and not has_var_kw:
            raise ValueError(
                f"{fn_name} does not contain '{req}' as an argument"
            )
    if has_var_kw:
        return fn

    def adapted(**kwargs):
        return fn(**{k: v for k, v in kwargs.items() if k in names})

    adapted.__name__ = getattr(fn, "__name__", fn_name)
    return adapted


def adapt_move_fn(move_fn):
    """Adapt an RMPF rejuvenation move for the batched engine.

    A move that declares ``particles`` (or no ``particle``) is batched like
    every engine model function and is called once. A move that declares
    ``particle`` (singular) is written for one particle, as the reference
    calls it: it gets a ``[2]`` key, one particle (``[]`` or ``[d]``) and
    its chain's parameters as 0-d tensors, and runs over all chains x
    particles under ``torch.func.vmap``; particle ``j`` of a chain takes
    key ``j`` of ``split(key, N)``, as in the JAX package. A function that
    vmap cannot trace (``.item()``, Python branches on tensor values)
    raises ``ValueError``.
    """
    names, _ = fn_param_names(move_fn)
    base = adapt_fn(move_fn, "move_fn")
    if "particle" not in names or "particles" in names:
        return base

    def per_particle(key, particles, y=None, t=None, **theta):
        c, n = particles.shape[:2]
        keys = threefry.split(key, n).reshape(c * n, 2)
        flat = particles.reshape((c * n,) + particles.shape[2:])
        rows = {q: v.repeat_interleave(n) for q, v in theta.items()}

        def one(k, p, th):
            return base(key=k, particle=p, y=y, t=t, **th)

        try:
            moved = torch.func.vmap(one)(keys, flat, rows)
        except RuntimeError as err:
            raise ValueError(
                "a move_fn that declares 'particle' runs under "
                "torch.func.vmap, which could not trace it (write it with "
                f"tensor operations only): {err}") from err
        return moved.reshape(particles.shape[:2] + moved.shape[1:])

    per_particle.__name__ = getattr(move_fn, "__name__", "move_fn")
    return per_particle


def check_params_match(
    init_fn, transition_fn, log_likelihood_fn, pilot_init_params, log_priors
) -> None:
    """The union of non-engine argument names of the three model functions
    must appear in both the initial-parameter dict and the log priors."""
    adapt_fn(init_fn, "init_fn", required=("num_particles",))
    adapt_fn(transition_fn, "transition_fn", required=("particles",))
    adapt_fn(log_likelihood_fn, "log_likelihood_fn",
             required=("particles", "y"))

    fn_params = set()
    for fn in (init_fn, transition_fn, log_likelihood_fn):
        fn_params |= fn_param_names(fn)[0]
    fn_params -= ENGINE_ARGS

    if not fn_params <= set(pilot_init_params):
        raise ValueError(
            "Parameters in functions do not match the names in "
            "pilot_init_params"
        )
    if not fn_params <= set(log_priors):
        raise ValueError(
            "Parameters in functions do not match the names in log_priors"
        )
