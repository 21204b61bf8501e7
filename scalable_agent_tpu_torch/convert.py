"""Weights between the JAX package's flax param tree and this port.

``flax_to_state_dict`` takes the JAX ``ImpalaAgent``'s params as numpy
arrays (what ``jax.device_get(params)`` gives, with or without the outer
``{"params": ...}``) and returns a ``state_dict`` for
``models.agent.ImpalaAgent``; ``state_dict_to_flax`` goes back.  Module
paths are the same, ``/`` for ``.`` (``convnet/residual_1_0/conv_0`` is
``convnet.residual_1_0.conv_0``).  The maps:

- conv kernels HWIO <-> OIHW (every 4-D ``kernel`` of ``convnet``: the
  shallow torso's three, the ResNet torso's fifteen);
- Dense kernels [in, out] <-> Linear weights [out, in];
- ``fc``: the port flattens the last activations in NHWC order like the
  JAX torsos, so its rows need no reordering;
- the eight ``core/lstm/{ii,if,ig,io,hi,hf,hg,ho}`` gate params <->
  ``core.wi [D,4H]``, ``core.wh [H,4H]``, ``core.b [4H]`` in (i, f, g, o)
  order; only the recurrent side carries a bias.  The instruction
  encoder's ``instruction/language_lstm/cell/*`` <-> ``instruction.wi``,
  ``.wh``, ``.b`` by the same map, and ``instruction/embed/embedding``
  <-> ``instruction.embed.weight`` as it is.

Both directions copy exactly (no arithmetic), so a round trip is bitwise.
The IMPACT target network is a second param tree (the JAX
``TrainState.target_params``, the port's ``TrainState.target_params``)
and takes the same two functions.

``layer_group`` sends each port parameter to the ``LAYER_GROUPS`` bucket
of the flax module it comes from, by the JAX learner's rule
(``runtime/learner.py`` ``_layer_group``): ``convnet/*`` (``fc``
included) is the torso, ``core/lstm/*`` the core, ``policy_logits`` and
``baseline`` the heads, anything else (the instruction encoder) the
torso.
"""

from typing import Dict, Mapping

import numpy as np
import torch

from scalable_agent_tpu_torch.obs.learning import LAYER_GROUPS

GATES = "ifgo"
# The port's top-level modules by the flax module each one holds.
_MODULE_GROUPS = {"convnet": "torso", "core": "core",
                  "policy_logits": "heads", "baseline": "heads"}
# Modules whose leaves are conv and Dense kernels with their biases.
_LAYERS = ("convnet", "policy_logits", "baseline")
# The done-reset LSTMs: the port's module, and the flax cell's path.
_LSTMS = {"core": "core/lstm", "instruction": "instruction/language_lstm/cell"}
_EMBED = ("instruction.embed.weight", "instruction/embed/embedding")


def _get(tree: Mapping, path: str):
    for key in path.split("/"):
        tree = tree[key]
    return tree


def _key(path: str) -> str:
    return path.replace("/", ".")


def layer_group(name: str) -> str:
    """The ``LAYER_GROUPS`` bucket of the port parameter ``name``."""
    return _MODULE_GROUPS.get(name.split(".")[0], "torso")


def flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    tree = params.get("params", params)
    arrays = {}

    def layers(node, path):
        if "kernel" in node:
            kernel = np.asarray(node["kernel"])
            arrays[_key(path) + ".weight"] = (
                np.transpose(kernel, (3, 2, 0, 1)) if kernel.ndim == 4
                else kernel.T)
            arrays[_key(path) + ".bias"] = np.asarray(node["bias"])
            return
        for name, child in node.items():
            layers(child, f"{path}/{name}")

    for module in _LAYERS:
        if module in tree:
            layers(tree[module], module)
    for module, path in _LSTMS.items():
        if module not in tree:
            continue
        cell = _get(tree, path)
        arrays[module + ".wi"] = np.concatenate(
            [np.asarray(cell["i" + g]["kernel"]) for g in GATES], axis=-1)
        arrays[module + ".wh"] = np.concatenate(
            [np.asarray(cell["h" + g]["kernel"]) for g in GATES], axis=-1)
        arrays[module + ".b"] = np.concatenate(
            [np.asarray(cell["h" + g]["bias"]) for g in GATES], axis=-1)
    if "instruction" in tree:
        arrays[_EMBED[0]] = np.asarray(_get(tree, _EMBED[1]))
    return {name: torch.from_numpy(np.array(a, np.float32))
            for name, a in arrays.items()}


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    sd = {name: t.detach().cpu().numpy() for name, t in state_dict.items()}
    tree: Dict = {}

    def put(path, leaf, value):
        node = tree
        for key in path.split("/"):
            node = node.setdefault(key, {})
        node[leaf] = np.ascontiguousarray(value)

    for name, value in sd.items():
        module, _, leaf = name.rpartition(".")
        if module.split(".")[0] not in _LAYERS:
            continue
        path = module.replace(".", "/")
        if leaf == "weight":
            put(path, "kernel", np.transpose(value, (2, 3, 1, 0))
                if value.ndim == 4 else value.T)
        else:
            put(path, "bias", value)
    for module, path in _LSTMS.items():
        if module + ".wh" not in sd:
            continue
        hidden = sd[module + ".wh"].shape[0]
        for n, g in enumerate(GATES):
            cols = slice(n * hidden, (n + 1) * hidden)
            put(f"{path}/i{g}", "kernel", sd[module + ".wi"][:, cols])
            put(f"{path}/h{g}", "kernel", sd[module + ".wh"][:, cols])
            put(f"{path}/h{g}", "bias", sd[module + ".b"][cols])
    if _EMBED[0] in sd:
        path, _, leaf = _EMBED[1].rpartition("/")
        put(path, leaf, sd[_EMBED[0]])
    return {"params": tree}

