"""Weights between the JAX package's flax param tree and this port.

``flax_to_state_dict`` takes the JAX ``ImpalaAgent``'s params as numpy
arrays (what ``jax.device_get(params)`` gives, with or without the outer
``{"params": ...}``) and returns a ``state_dict`` for
``models.agent.ImpalaAgent``; ``state_dict_to_flax`` goes back.  The maps:

- conv kernels HWIO <-> OIHW;
- Dense kernels [in, out] <-> Linear weights [out, in];
- ``fc``: the port flattens the conv stack in NHWC order like the JAX
  torso, so its rows need no reordering;
- the eight ``core/lstm/{ii,if,ig,io,hi,hf,hg,ho}`` gate params <->
  ``core.wi [D,4H]``, ``core.wh [H,4H]``, ``core.b [4H]`` in (i, f, g, o)
  order; only the recurrent side carries a bias.

Both directions copy exactly (no arithmetic), so a round trip is bitwise.

``layer_group`` sends each port parameter to the ``LAYER_GROUPS`` bucket
of the flax module it comes from, by the JAX learner's rule
(``runtime/learner.py`` ``_layer_group``): ``convnet/*`` (``fc``
included) is the torso, ``core/lstm/*`` the core, ``policy_logits`` and
``baseline`` the heads, anything else the torso.
"""

from typing import Dict, Mapping

import numpy as np
import torch

from scalable_agent_tpu_torch.obs.learning import LAYER_GROUPS

GATES = "ifgo"
# The port's top-level modules by the flax module each one holds.
_MODULE_GROUPS = {"convnet": "torso", "core": "core",
                  "policy_logits": "heads", "baseline": "heads"}
_DENSE = ("convnet/fc", "policy_logits", "baseline")
_CONVS = ("convnet/conv_0", "convnet/conv_1", "convnet/conv_2")


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
    for path in _CONVS:
        arrays[_key(path) + ".weight"] = np.transpose(
            np.asarray(_get(tree, path + "/kernel")), (3, 2, 0, 1))
        arrays[_key(path) + ".bias"] = np.asarray(_get(tree, path + "/bias"))
    for path in _DENSE:
        arrays[_key(path) + ".weight"] = np.asarray(
            _get(tree, path + "/kernel")).T
        arrays[_key(path) + ".bias"] = np.asarray(_get(tree, path + "/bias"))
    lstm = tree["core"]["lstm"]
    arrays["core.wi"] = np.concatenate(
        [np.asarray(lstm["i" + g]["kernel"]) for g in GATES], axis=-1)
    arrays["core.wh"] = np.concatenate(
        [np.asarray(lstm["h" + g]["kernel"]) for g in GATES], axis=-1)
    arrays["core.b"] = np.concatenate(
        [np.asarray(lstm["h" + g]["bias"]) for g in GATES], axis=-1)
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

    for path in _CONVS:
        put(path, "kernel", np.transpose(sd[_key(path) + ".weight"],
                                         (2, 3, 1, 0)))
        put(path, "bias", sd[_key(path) + ".bias"])
    for path in _DENSE:
        put(path, "kernel", sd[_key(path) + ".weight"].T)
        put(path, "bias", sd[_key(path) + ".bias"])
    hidden = sd["core.wh"].shape[0]
    for n, g in enumerate(GATES):
        cols = slice(n * hidden, (n + 1) * hidden)
        put("core/lstm/i" + g, "kernel", sd["core.wi"][:, cols])
        put("core/lstm/h" + g, "kernel", sd["core.wh"][:, cols])
        put("core/lstm/h" + g, "bias", sd["core.b"][cols])
    return {"params": tree}
