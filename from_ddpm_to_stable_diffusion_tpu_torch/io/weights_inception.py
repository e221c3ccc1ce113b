"""pytorch-fid InceptionV3 checkpoint -> ``models.inception.InceptionV3FID``
(port of ``io/weights_inception.py``).

The canonical FID featurizer weights (``pt_inception-2015-12-05-6726825d.pth``,
torchvision InceptionV3 naming with num_classes=1008) import here with every
BatchNorm FOLDED into a per-channel affine, in fp32:

    scale = bn.weight / sqrt(bn.running_var + 1e-3)
    bias  = bn.bias - bn.running_mean * scale

so each ``BasicConv2d`` of the port is conv -> affine -> relu with no
running statistics. The ``fc`` / ``AuxLogits`` heads are dropped (FID uses
the pool3 features only).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from .weights import Rules, apply_rules, load_torch_state_dict, t_conv, t_none

BN_EPS = 1e-3  # torchvision BasicConv2d BatchNorm eps

_BRANCHES = {
    "Mixed_5b": ["branch1x1", "branch5x5_1", "branch5x5_2",
                 "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3",
                 "branch_pool"],
    "Mixed_6a": ["branch3x3", "branch3x3dbl_1", "branch3x3dbl_2",
                 "branch3x3dbl_3"],
    "Mixed_6b": ["branch1x1", "branch7x7_1", "branch7x7_2", "branch7x7_3",
                 "branch7x7dbl_1", "branch7x7dbl_2", "branch7x7dbl_3",
                 "branch7x7dbl_4", "branch7x7dbl_5", "branch_pool"],
    "Mixed_7a": ["branch3x3_1", "branch3x3_2", "branch7x7x3_1",
                 "branch7x7x3_2", "branch7x7x3_3", "branch7x7x3_4"],
    "Mixed_7b": ["branch1x1", "branch3x3_1", "branch3x3_2a", "branch3x3_2b",
                 "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3a",
                 "branch3x3dbl_3b", "branch_pool"],
}
_BRANCHES["Mixed_5c"] = _BRANCHES["Mixed_5d"] = _BRANCHES["Mixed_5b"]
_BRANCHES["Mixed_6c"] = _BRANCHES["Mixed_6d"] = _BRANCHES["Mixed_6e"] = \
    _BRANCHES["Mixed_6b"]
_BRANCHES["Mixed_7c"] = _BRANCHES["Mixed_7b"]

_STEM = ["Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3",
         "Conv2d_3b_1x1", "Conv2d_4a_3x3"]

_MIXED_ORDER = ["Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b",
                "Mixed_6c", "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b",
                "Mixed_7c"]


def basic_conv_paths() -> List[str]:
    """Every BasicConv2d module path, torch == flax == port naming."""
    paths = list(_STEM)
    for mixed in _MIXED_ORDER:
        paths += [f"{mixed}.{b}" for b in _BRANCHES[mixed]]
    return paths


def fold_batchnorm(state: Dict[str, torch.Tensor]):
    """Replace each module's bn.{weight,bias,running_*} with folded fp32
    ``bn_scale`` / ``bn_bias`` keys, in place."""
    for path in basic_conv_paths():
        w = state.pop(f"{path}.bn.weight").float()
        b = state.pop(f"{path}.bn.bias").float()
        mean = state.pop(f"{path}.bn.running_mean").float()
        var = state.pop(f"{path}.bn.running_var").float()
        state.pop(f"{path}.bn.num_batches_tracked", None)
        # each step rounded once to fp32, as numpy's fp32 arithmetic in the
        # JAX importer (torch's fp32 sqrt on the CPU is off by an ulp now
        # and then; the fp64 root rounded to fp32 is the correct one)
        scale = w / torch.sqrt((var + BN_EPS).double()).float()
        state[f"{path}.bn_scale"] = scale
        state[f"{path}.bn_bias"] = b - mean * scale


def inception_fid_rules() -> Rules:
    r: Rules = []
    for path in basic_conv_paths():
        f = path.replace(".", "/")
        r += [(f"{path}.conv.weight", f"{f}/conv/kernel", t_conv),
              (f"{path}.bn_scale", f"{f}/scale", t_none),
              (f"{path}.bn_bias", f"{f}/bias", t_none)]
    return r


def import_inception_fid(path: str) -> Dict[str, torch.Tensor]:
    """The ``InceptionV3FID`` ``state_dict`` of a pytorch-fid checkpoint."""
    state = load_torch_state_dict(path)
    state = {k: v for k, v in state.items()
             if not k.startswith(("fc.", "AuxLogits."))}
    fold_batchnorm(state)
    return apply_rules(state, inception_fid_rules())
