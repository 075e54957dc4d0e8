"""Model weights across the two packages: the reference's flat-key npz
format (``layers/0/w``, ``sage/0/w_self``, ``embed``, ``num_heads`` …; the reference's
``trainer/serving.py``) and its parameter trees as numpy, turned into this
port's modules.

Bytes cross both ways: what ``serialize_params`` writes loads in the
reference's ``deserialize_params_auto``, and the reference's bytes load
here.
"""

from __future__ import annotations

import io
from typing import Any

import numpy as np
import torch
from torch import nn

from dragonfly2_torch.device import resolve_device
from dragonfly2_torch.models.attention import TransformerEncoder
from dragonfly2_torch.models.gnn import GraphSAGE
from dragonfly2_torch.models.gru import GRU
from dragonfly2_torch.models.mlp import MLP


def _listify(node):
    """All-integer dict levels become lists (the reference's rule)."""
    if not isinstance(node, dict):
        return node
    if node and all(k.isdigit() for k in node):
        return [_listify(node[k]) for k in sorted(node, key=int)]
    return {k: _listify(v) for k, v in node.items()}


def _nest(flat: "dict[str, Any]", sep: str) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        parts = key.split(sep)
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return _listify(tree)


def module_tree(module: nn.Module) -> dict:
    """A port module → the reference's parameter tree as numpy float32
    arrays (plus the module's ``tree_ints`` as ints)."""
    flat: dict[str, Any] = {
        name: p.detach().to("cpu", torch.float32).numpy()
        for name, p in module.named_parameters()
    }
    for name in getattr(module, "tree_ints", ()):
        flat[name] = int(getattr(module, name))
    return _nest(flat, ".")


def _flatten(tree, prefix: str, out: dict) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}/", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}/", out)
    else:
        if isinstance(tree, torch.Tensor):
            tree = tree.detach().cpu().numpy()
        out[prefix[:-1]] = np.asarray(tree)


def serialize_params(params: "nn.Module | dict") -> bytes:
    """A port module or a parameter tree (dicts/lists of arrays, tensors or
    ints) → npz bytes with the reference's flat ``a/0/b`` keys."""
    if isinstance(params, nn.Module):
        params = module_tree(params)
    arrays: dict[str, np.ndarray] = {}
    _flatten(params, "", arrays)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def deserialize_params_auto(blob: bytes) -> dict:
    """npz bytes → parameter tree, its structure rebuilt from the flat keys
    alone (all-integer levels become lists)."""
    with np.load(io.BytesIO(blob)) as z:
        return _nest({key: z[key] for key in z.files}, "/")


def _load(module: nn.Module, tree: dict, device) -> nn.Module:
    flat: dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    state = {
        key.replace("/", "."): torch.tensor(np.asarray(value, np.float32))
        for key, value in flat.items()
        if key not in getattr(module, "tree_ints", ())
    }
    module.load_state_dict(state, strict=True)
    return module.to(resolve_device(device))


def mlp_from_numpy(tree: dict, device="cuda") -> MLP:
    """The reference's ``{'layers': [{'w', 'b'}, ...]}`` → ``MLP`` on
    ``device``."""
    layers = tree["layers"]
    dims = [np.shape(layers[0]["w"])[0]] + [np.shape(l["w"])[1] for l in layers]
    return _load(MLP(dims), tree, device)


def transformer_from_numpy(tree: dict, device="cuda") -> TransformerEncoder:
    """The reference's ``init_transformer`` tree → ``TransformerEncoder`` on
    ``device``."""
    in_dim, model_dim = np.shape(tree["embed"])
    num_heads = int(np.asarray(tree["num_heads"]))
    hidden = np.shape(tree["layers"][0]["w1"])[1] if tree["layers"] else 4 * model_dim
    if int(np.asarray(tree["head_dim"])) * num_heads != model_dim:
        raise ValueError("num_heads·head_dim does not match the embedding width")
    enc = TransformerEncoder(
        in_dim, model_dim, num_heads, len(tree["layers"]), hidden // model_dim
    )
    head_dims = [model_dim] + [np.shape(l["w"])[1] for l in tree["head"]["layers"]]
    enc.head = MLP(head_dims)
    return _load(enc, tree, device)


def graphsage_from_numpy(tree: dict, device="cuda") -> GraphSAGE:
    """The reference's ``init_graphsage`` tree (``sage``, ``head``, and
    ``node_embed`` when it has one) → ``GraphSAGE`` on ``device``."""
    sage = tree["sage"]
    in_dim = np.shape(sage[0]["w_self"])[0]
    num_nodes, embed_dim = None, 16
    if "node_embed" in tree:
        num_nodes, embed_dim = np.shape(tree["node_embed"])
        in_dim -= embed_dim
    model = GraphSAGE(
        in_dim,
        [np.shape(layer["w_self"])[1] for layer in sage],
        head_hidden=np.shape(tree["head"]["layers"][0]["w"])[1],
        num_nodes=num_nodes,
        embed_dim=embed_dim,
    )
    return _load(model, tree, device)


def gru_from_numpy(tree: dict, device="cuda") -> GRU:
    """The reference's ``init_gru`` tree (``wz`` … ``bh`` and ``head``) →
    ``GRU`` on ``device``."""
    in_dim, hidden = np.shape(tree["wz"])
    head_hidden = np.shape(tree["head"]["layers"][0]["w"])[1]
    return _load(GRU(in_dim, hidden, head_hidden), tree, device)
