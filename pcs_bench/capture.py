"""What a segmentation model computed on the way to its logits, caught by
forward hooks and copied to the host: the pyramid the encoder was given
(Morton-sorted points and pooled levels), the neighbourhood every conv was
given, and the logits.  The same hooks read the program's model and the
reference's, whose module names are alike, so the two can be compared
field by field."""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, List

import torch
from torch import nn


def _tensors(obj) -> Dict[str, torch.Tensor]:
    """The tensor fields of a pyramid or neighbourhood, by field path."""
    out = {}
    if isinstance(obj, torch.Tensor):
        return {"": obj}
    if dataclasses.is_dataclass(obj):
        items = [(f.name, getattr(obj, f.name))
                 for f in dataclasses.fields(obj)]
    elif isinstance(obj, tuple) and hasattr(obj, "_fields"):
        items = list(zip(obj._fields, obj))
    elif isinstance(obj, (tuple, list)):
        items = [(str(i), v) for i, v in enumerate(obj)]
    else:
        return {}
    for name, v in items:
        for sub, t in _tensors(v).items():
            out[f"{name}.{sub}" if sub else name] = t
    return out


def _is_neighbourhood(obj) -> bool:
    return hasattr(obj, "mask") and (hasattr(obj, "lidx")
                                     or hasattr(obj, "idx"))


class Capture:
    """Per block: ``pyramid`` {field: tensor}, ``neighbours`` {module.field:
    tensor}, ``logits`` tensor; all on the host."""

    def __init__(self):
        self.blocks: List[Dict] = []

    def _new_block(self):
        self.blocks.append({"pyramid": {}, "neighbours": {}, "logits": None})


@contextlib.contextmanager
def capture(model: nn.Module) -> Iterator[Capture]:
    """Hooks on ``model`` (a segmentation model with an ``encoder``) while
    the context is open; every forward of ``model`` adds one block."""
    cap = Capture()
    handles = []

    def on_model_pre(_mod, _args):
        cap._new_block()

    def on_model(_mod, _args, out):
        cap.blocks[-1]["logits"] = out.detach().float().cpu()

    def on_encoder(_mod, args):
        cap.blocks[-1]["pyramid"] = {
            k: v.detach().cpu() for k, v in _tensors(args[0]).items()}

    def on_conv(name):
        def hook(_mod, args):
            if len(args) > 2 and _is_neighbourhood(args[2]):
                cap.blocks[-1]["neighbours"].update(
                    {f"{name}.{k}": v.detach().cpu()
                     for k, v in _tensors(args[2]).items()})
        return hook

    handles.append(model.register_forward_pre_hook(on_model_pre))
    handles.append(model.register_forward_hook(on_model))
    handles.append(model.encoder.register_forward_pre_hook(on_encoder))
    for name, mod in model.named_modules():
        if name.startswith("encoder."):
            handles.append(mod.register_forward_pre_hook(on_conv(name)))
    try:
        yield cap
    finally:
        for h in handles:
            h.remove()


def mismatches(a: Dict[str, torch.Tensor],
               b: Dict[str, torch.Tensor]) -> int:
    """Elements that differ between two captures of the same fields; a
    field missing on one side or of another shape counts every element."""
    n = 0
    for key in set(a) | set(b):
        if key not in a or key not in b or a[key].shape != b[key].shape:
            n += max(a[key].numel() if key in a else 0,
                     b[key].numel() if key in b else 0)
            continue
        n += int((a[key] != b[key]).sum())
    return n
