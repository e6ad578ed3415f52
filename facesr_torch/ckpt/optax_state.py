"""The port's optimiser state to and from the tree the JAX package's
``.fckpt`` holds for it: flax's ``to_state_dict`` of the optax state of the
optimiser its Trainer builds for the same settings.

Which optax composition stands for a port optimiser:

- `training.optim.AdamW` is ``make_optimizer`` (`facesr/training/steps.py`):
  ``chain(clip_by_global_norm, inject_hyperparams(adamw))`` (no clip state
  when ``gradient_clip`` is 0), inside ``multi_transform({"frozen":
  set_to_zero, "train": ...})`` when ``labels`` are given (a transfer
  model: its trained parameters are "train"), inside ``MultiSteps`` when
  ``accumulation_steps > 1``, inside ``apply_if_finite`` when
  ``skip_nonfinite > 0``. The discriminator's optimiser is the same with
  no clip.
- `training.optim.StageAdamW` is the transfer model's
  ``make_stage_optimizer`` (`facesr/models/transfer.py`):
  ``multi_transform({"frozen": set_to_zero, "backbone": adamw or
  set_to_zero when its rate is 0, "head": adamw})``, after
  ``clip_by_global_norm`` when it clips, inside ``apply_if_finite`` when
  the Trainer's config skips non-finite steps.

In that tree a tuple is ``{"0": .., "1": ..}``, an empty state
(``EmptyState``, ``set_to_zero``, the clip) is an empty map, a parameter
that a ``multi_transform`` group does not own is an empty map
(``MaskedNode``) in that group's moments, and scalars keep optax's dtypes:
counts and steps int32, hyperparameters float32, ``last_finite`` bool.
Parameter-shaped leaves are in the JAX layout of the model family
(``kind``: ``custom``, ``transfer``, ``esrgan`` or ``disc``), converted by
`ckpt.weights`.

The port keeps one step count for what optax counts several times (the
injected hyperparameters' count and each group's Adam count advance
together in all these compositions), the moments of the parameters it
trains, and no optimiser hyperparameters but the learning rate. Writing
fills the rest as optax's ``init`` and updates leave it: zero moments and
accumulators for parameters the port does not step, the hyperparameters
from the optimiser's settings. Reading checks the file's tree against the
one this optimiser would write, leaf by leaf (keys, shapes, dtypes), and
raises ValueError naming the first path that differs; counts that differ
where the port holds one, and injected hyperparameters other than the
learning rate that differ from this optimiser's (optax reads them from the
state), also raise.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from facesr_torch.training.optim import AdamW, StageAdamW

__all__ = ["jax_tree", "port_dict", "optax_state_dict", "port_state_from_optax",
           "check_tree", "stage_labels"]

Tensors = Dict[str, torch.Tensor]
Labels = Optional[Dict[str, str]]

_GROUP_CODES = {"frozen": 0, "train": 1, "backbone": 1, "head": 2}


def _as_state_dict(tree: Any) -> Any:
    """flax's ``to_state_dict`` of a pytree: lists and tuples become maps
    keyed '0', '1', ..."""
    if isinstance(tree, dict):
        return {k: _as_state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _as_state_dict(v) for i, v in enumerate(tree)}
    return tree


def jax_tree(kind: str, named: Tensors) -> Any:
    """A full {parameter name: tensor} dict of a model family as its JAX
    parameter tree in state-dict form (numpy leaves)."""
    from facesr_torch.ckpt import weights

    if kind == "disc":
        return _as_state_dict(weights.jax_discriminator_from_state_dict(named)[0])
    if kind == "transfer":
        return _as_state_dict(weights.jax_params_from_transfer_state_dict(named))
    if kind == "esrgan":
        return _as_state_dict(weights.jax_params_from_esrgan_state_dict(named))
    if kind in ("custom", "lite"):
        return _as_state_dict(weights.jax_params_from_state_dict(named))
    raise ValueError(f"unknown parameter layout {kind!r}")


def port_dict(kind: str, tree: Any) -> Tensors:
    """The inverse of `jax_tree`: {parameter name: tensor} on the CPU."""
    from facesr_torch.ckpt import weights
    from facesr_torch.ckpt.fckpt import restore_list_nodes

    tree = restore_list_nodes(tree)
    if kind == "disc":
        stats = {"blocks": [{"mean": np.zeros(0), "var": np.zeros(0)} if "gamma" in b else {}
                            for b in tree["blocks"]]}
        sd = weights.discriminator_state_dict_from_jax(tree, stats)
        return {k: v for k, v in sd.items() if ".running_" not in k}
    return weights.state_dict_from_jax(tree, kind)


def _leaves(tree: Any, path=()):
    """(path, leaf) of every array leaf, in key order."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], path + (k,))
    elif tree is not None:
        yield path, tree


def _label_tree(kind: str, params: Tensors, labels: Dict[str, str]) -> Dict[tuple, str]:
    """The group of every JAX leaf, from the port's per-parameter labels
    (a JAX leaf stacks many parameters, which must share one group)."""
    codes = {n: torch.full(p.shape, float(_GROUP_CODES[labels[n]])) for n, p in params.items()}
    names = {c: g for g, c in _GROUP_CODES.items() if g != "train"}
    names[1] = "train" if "train" in labels.values() else "backbone"
    out = {}
    for path, leaf in _leaves(jax_tree(kind, codes)):
        values = np.unique(np.asarray(leaf))
        if values.size != 1:
            raise ValueError(f"JAX leaf {'/'.join(path)} stacks parameters of several groups")
        out[path] = names[int(values[0])]
    return out


def _full(named: Tensors, params: Tensors) -> Tensors:
    """``named`` completed with zeros for every parameter it lacks."""
    return {n: (named[n] if n in named else torch.zeros(p.shape)).detach().cpu().float()
            for n, p in params.items()}


def _masked(tree: Any, groups: Dict[tuple, str], keep: set, path=()) -> Any:
    """A copy of ``tree`` with every leaf of a group outside ``keep`` as an
    empty map (optax's MaskedNode)."""
    if isinstance(tree, dict):
        return {k: _masked(v, groups, keep, path + (k,)) for k, v in tree.items()}
    if tree is None or groups[path] in keep:
        return tree
    return {}


def _i32(v) -> np.ndarray:
    return np.asarray(int(v), np.int32)


def _f32(v) -> np.ndarray:
    return np.asarray(float(v), np.float32)


def _adam(count, mu, nu) -> Dict[str, Any]:
    return {"count": _i32(count), "mu": mu, "nu": nu}


def _hyperparams(opt: AdamW, lr) -> Dict[str, np.ndarray]:
    """``inject_hyperparams(adamw)``'s hyperparameters for ``opt`` at ``lr``."""
    return {"learning_rate": _f32(lr), "b1": _f32(opt.b1), "b2": _f32(opt.b2),
            "eps": _f32(opt.eps), "eps_root": _f32(0.0), "weight_decay": _f32(opt.weight_decay)}


def stage_labels(opt, state: Dict[str, Any], params: Tensors, model_type: str) -> Labels:
    """The per-parameter groups of an optimiser's multi_transform: a
    `StageAdamW`'s own labels; for `AdamW` on a transfer model (the JAX
    Trainer's ``param_labels``), "train" for what the state steps and
    "frozen" for the rest; None otherwise."""
    if isinstance(opt, StageAdamW):
        return {n: opt.labels[n] for n in params}
    if model_type == "transfer":
        return {n: "train" if n in state["mu"] else "frozen" for n in params}
    return None


def optax_state_dict(opt: AdamW, state: Dict[str, Any], kind: str, params: Tensors,
                     labels: Labels = None) -> Dict[str, Any]:
    """The optax state tree of ``opt`` holding ``state``. ``params`` is the
    model's full {name: tensor} dict (shapes, and the parameters the state
    lacks); ``labels`` the multi_transform groups (`stage_labels`)."""
    if type(opt) not in (AdamW, StageAdamW):
        raise ValueError(f"no optax counterpart is known for {type(opt).__name__}")
    count = int(state["count"])
    mu, nu = (jax_tree(kind, _full(state[k], params)) for k in ("mu", "nu"))
    groups = _label_tree(kind, params, labels) if labels is not None else None
    clip = bool(opt.gradient_clip and opt.gradient_clip > 0)

    if isinstance(opt, StageAdamW):
        inner = {}
        for group in ("frozen", "backbone", "head"):
            if opt.lrs[group] > 0:
                adam = _adam(count, _masked(mu, groups, {group}), _masked(nu, groups, {group}))
                inner[group] = {"inner_state": {"0": adam, "1": {}, "2": {}}}
            else:  # set_to_zero
                inner[group] = {"inner_state": {}}
        tree: Dict[str, Any] = {"inner_states": inner}
        if clip:
            tree = {"0": {}, "1": tree}
    else:
        if groups is not None:
            mu, nu = _masked(mu, groups, {"train"}), _masked(nu, groups, {"train"})
        inject = {"count": _i32(count), "hyperparams": _hyperparams(opt, state["lr"]),
                  "hyperparams_states": {},
                  "inner_state": {"0": _adam(count, mu, nu), "1": {}, "2": {}}}
        tree = {"0": {}, "1": inject} if clip else {"0": inject}
        if groups is not None:
            tree = {"inner_states": {"frozen": {"inner_state": {}},
                                     "train": {"inner_state": tree}}}
    if opt.accumulation_steps > 1:
        tree = {"mini_step": _i32(state["mini_step"]),
                "gradient_step": _i32(state["gradient_step"]),
                "inner_opt_state": tree,
                "acc_grads": jax_tree(kind, _full(state["acc"], params)),
                "skip_state": {}}
    if opt.skip_nonfinite > 0:
        tree = {"notfinite_count": _i32(state["notfinite_count"]),
                "last_finite": np.asarray(bool(state["last_finite"]), np.bool_),
                "total_notfinite": _i32(state["total_notfinite"]),
                "inner_state": tree}
    return tree


def _describe(node: Any) -> str:
    if node is None:
        return "None"
    if isinstance(node, dict):
        return "an empty map" if not node else f"a map of {sorted(node)}"
    return f"{_dtype_name(node)} {tuple(np.shape(node))}"


def _dtype_name(leaf: Any) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return np.asarray(leaf).dtype.name


def check_tree(got: Any, want: Any, where: str) -> None:
    """Raise ValueError at the first path where ``got`` differs from
    ``want`` in structure, shape or dtype (values are not compared)."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise ValueError(f"{where}: the file has {_describe(got)}, this trainer's "
                             f"optimiser state has {_describe(want)}")
        for k in want:
            check_tree(got[k], want[k], f"{where}/{k}")
    elif want is None:
        if got is not None:
            raise ValueError(f"{where}: the file has {_describe(got)}, expected None")
    elif (isinstance(got, dict) or got is None
          or tuple(np.shape(got)) != tuple(np.shape(want))
          or _dtype_name(got) != _dtype_name(want)):
        raise ValueError(f"{where}: the file has {_describe(got)}, expected {_describe(want)}")


def _merge(trees: List[Any], like: Any) -> Any:
    """One parameter tree from several groups' moments: each leaf from the
    group that owns it (an array there), zeros where none does."""
    out = {}
    for k, v in like.items():
        if isinstance(v, dict):
            out[k] = _merge([t[k] for t in trees], v)
        elif v is None:
            out[k] = None
        else:
            owned = [t[k] for t in trees if not isinstance(t[k], dict)]
            out[k] = np.asarray(owned[0]) if owned else np.zeros_like(v)
    return out


def port_state_from_optax(opt: AdamW, tree: Dict[str, Any], like: Dict[str, Any], kind: str,
                          params: Tensors, labels: Labels = None,
                          where: str = "opt_state") -> Dict[str, Any]:
    """The port state of ``opt`` read from an optax state tree, shaped and
    placed as ``like`` (this optimiser's current state)."""
    check_tree(tree, optax_state_dict(opt, like, kind, params, labels), where)
    new: Dict[str, Any] = {}
    node = tree
    if opt.skip_nonfinite > 0:
        for k in ("notfinite_count", "last_finite", "total_notfinite"):
            new[k] = node[k]
        node = node["inner_state"]
    if opt.accumulation_steps > 1:
        new["mini_step"], new["gradient_step"] = node["mini_step"], node["gradient_step"]
        acc = node["acc_grads"]
        node = node["inner_opt_state"]
    clip = bool(opt.gradient_clip and opt.gradient_clip > 0)
    counts: Dict[str, int] = {}
    if isinstance(opt, StageAdamW):
        node = node["1"] if clip else node
        adams = {g: s["inner_state"]["0"] for g, s in node["inner_states"].items()
                 if s["inner_state"]}
    else:
        if labels is not None:
            node = node["inner_states"]["train"]["inner_state"]
        inject = node["1"] if clip else node["0"]
        new["lr"] = inject["hyperparams"]["learning_rate"]
        # optax's update reads these from the state, so a file written with
        # other settings would continue otherwise in JAX than here
        for k, v in _hyperparams(opt, new["lr"]).items():
            if np.asarray(inject["hyperparams"][k]) != v:
                raise ValueError(
                    f"{where}: the file's {k} is {float(inject['hyperparams'][k])!r}, this "
                    f"trainer's optimiser uses {float(v)!r}; resume with the file's setting")
        counts["injected hyperparameters"] = int(inject["count"])
        adams = {"train": inject["inner_state"]["0"]}
    counts.update({f"{g} adam": int(a["count"]) for g, a in adams.items()})
    if len(set(counts.values())) != 1:
        raise ValueError(f"{where}: step counts differ ({counts}); the port keeps one")
    new["count"] = next(iter(counts.values()))
    zeros = jax_tree(kind, _full({}, params))
    for k in ("mu", "nu"):
        new[k] = port_dict(kind, _merge([a[k] for a in adams.values()], zeros))
    if opt.accumulation_steps > 1:
        new["acc"] = port_dict(kind, acc)

    out = {}
    for k, ref in like.items():
        if isinstance(ref, dict):
            out[k] = {n: new[k][n].to(device=t.device, dtype=t.dtype).contiguous()
                      for n, t in ref.items()}
        else:
            out[k] = torch.tensor(np.asarray(new[k])).to(device=ref.device, dtype=ref.dtype)
    return out
