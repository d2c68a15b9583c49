"""User-function signature adaptation and validation (port of
``bayesssm_tpu/utils/signatures.py``).

Model functions declare only the arguments they use; the engine calls
every one of them with its full keyword set ``(key, particles, y, t,
num_particles, **theta)`` through :func:`adapt_fn`, which drops what the
signature does not declare. The messages are the JAX package's, which
are the reference's. ``adapt_move_fn`` waits for RMPF through the engine
(ROADMAP Queue 1).
"""

from __future__ import annotations

import inspect

__all__ = ["ENGINE_ARGS", "adapt_fn", "check_params_match", "fn_param_names"]

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
