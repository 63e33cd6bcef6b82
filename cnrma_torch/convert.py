"""Reference PyTorch checkpoints (``.pth``) to the port's state dicts.

A copy of the numpy mapping of ``tools/convert_checkpoint.py``
(``Converter``, ``convert_state_dict``): the reference's state-dict names
(``fpn.*`` = detectron R50+FPN, ``feature_2d.*`` = the pyramid fuse,
``backbone3d.*`` = the 3D U-Net, ``tsdf_head.decoders.*``,
``detection_backbone.*`` / ``detection_head.*`` = the MinkowskiEngine
sparse nets), or the bare Caffe2 R-50 of ``backbone2d.pretrained``
(``bottom_up.*``), become the JAX package's flax variable tree, which
``bridge.from_flax`` turns into the port's names.  So a reference tensor
lands in the port exactly where it lands in the JAX package.

Weight layout notes (from the original):
* torch Conv2d [Cout,Cin,kh,kw] -> flax [kh,kw,Cin,Cout];
  Conv3d [Cout,Cin,kd,kh,kw] -> [kd,kh,kw,Cin,Cout] (and back to torch's
  layout in ``from_flax``);
* ME sparse kernels are already [K,Cin,Cout]; ME enumerates kernel offsets
  with the first coordinate fastest, the same order as the port's
  ``ops.sparse.kernel_offsets`` — pass ``me_offset_order="zyx"`` if a
  checkpoint disagrees.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from cnrma_torch.bridge import from_flax


def t2f_conv2d(w):
    return np.transpose(w, (2, 3, 1, 0))


def t2f_conv3d(w):
    return np.transpose(w, (2, 3, 4, 1, 0))


def set_in(tree, path, value):
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = np.asarray(value)


class Converter:
    """reference state-dict -> {params, batch_stats} trees."""

    def __init__(self, me_offset_order: str = "xyz"):
        self.params = {}
        self.stats = {}
        self.unused = []
        self.me_offset_order = me_offset_order

    # -- helpers -----------------------------------------------------------
    def conv_bn(self, sd, src, dst, conv3d=False, conv_name="conv",
                norm_name="norm"):
        """torch Conv+BN pair at ``src{.weight,.norm.*}`` -> our ConvBN."""
        w = sd.get(f"{src}.weight")
        if w is None:
            return False
        tr = t2f_conv3d if conv3d else t2f_conv2d
        set_in(self.params, dst + (conv_name, "kernel"), tr(w))
        if f"{src}.bias" in sd:
            set_in(self.params, dst + (conv_name, "bias"),
                   sd[f"{src}.bias"])
        for suffix in ("norm", ""):  # detectron fuses norm into conv.norm
            base = f"{src}.{suffix}" if suffix else src
            if f"{base}.running_mean" in sd:
                set_in(self.params, dst + (norm_name, "scale"),
                       sd[f"{base}.weight"] if suffix else
                       sd[f"{base}.norm.weight"])
                set_in(self.params, dst + (norm_name, "bias"),
                       sd[f"{base}.bias"])
                set_in(self.stats, dst + (norm_name, "mean"),
                       sd[f"{base}.running_mean"])
                set_in(self.stats, dst + (norm_name, "var"),
                       sd[f"{base}.running_var"])
                break
        return True

    def plain_bn(self, sd, src, dst):
        if f"{src}.running_mean" not in sd:
            return False
        set_in(self.params, dst + ("scale",), sd[f"{src}.weight"])
        set_in(self.params, dst + ("bias",), sd[f"{src}.bias"])
        set_in(self.stats, dst + ("mean",), sd[f"{src}.running_mean"])
        set_in(self.stats, dst + ("var",), sd[f"{src}.running_var"])
        return True

    def me_kernel(self, sd, src, dst, name="kernel"):
        w = sd.get(f"{src}.kernel")
        if w is None:
            return False
        w = np.asarray(w)
        if w.ndim == 2:                       # 1x1 conv stored [Cin,Cout]
            w = w[None]
        if self.me_offset_order == "zyx" and w.shape[0] in (8, 27):
            k = round(w.shape[0] ** (1 / 3))
            w = w.reshape(k, k, k, *w.shape[1:])
            w = np.transpose(w, (2, 1, 0, 3, 4)).reshape(-1, *w.shape[3:])
        set_in(self.params, dst + (name,), w)
        if f"{src}.bias" in sd:
            bias_name = "bias" if name == "kernel" else f"{name}_bias"
            set_in(self.params, dst + (bias_name,), sd[f"{src}.bias"])
        return True

    # -- component mappings ------------------------------------------------
    def convert_2d_tower(self, sd, prefix="fpn."):
        res = ("tower2d", "resnet")
        self.conv_bn(sd, f"{prefix}bottom_up.stem.conv1", res + ("stem",))
        stage_sizes = {2: 3, 3: 4, 4: 6, 5: 3}
        for s, n in stage_sizes.items():
            for b in range(n):
                base = f"{prefix}bottom_up.res{s}.{b}"
                dst = res + (f"res{s}_block{b}",)
                for conv in ("conv1", "conv2", "conv3"):
                    self.conv_bn(sd, f"{base}.{conv}", dst + (conv,))
                self.conv_bn(sd, f"{base}.shortcut", dst + ("shortcut",))
        for s in range(2, 6):
            self.conv_bn(sd, f"{prefix}fpn_lateral{s}",
                         ("tower2d", "fpn", f"lateral{s}"))
            self.conv_bn(sd, f"{prefix}fpn_output{s}",
                         ("tower2d", "fpn", f"output{s}"))

    def convert_fuse(self, sd, prefix="feature_2d."):
        # AtlasFPNFeature scale heads: p2 has 1 conv; p3..p5 have 1..3
        # convs each followed by an upsample (sequential indices 0,2,4)
        for i, name in enumerate(["p2", "p3", "p4", "p5"]):
            n_convs = max(1, i)
            for k in range(n_convs):
                self.conv_bn(sd, f"{prefix}{name}.{k * 2}",
                             ("tower2d", "fuse", f"{name}_head{k}"))

    def convert_unet3d(self, sd, prefix="backbone3d."):
        dst0 = ("backbone3d",)

        def block(src, d):
            # BasicBlock3d names its norms bn1/bn2 as separate modules
            # (backbone3d.py:61-66), unlike detectron's fused conv.norm
            w = sd.get(f"{src}.conv1.weight")
            if w is not None:
                set_in(self.params, d + ("conv1", "conv", "kernel"),
                       t2f_conv3d(w))
            self.plain_bn(sd, f"{src}.bn1", d + ("conv1", "norm"))
            w = sd.get(f"{src}.conv2.weight")
            if w is not None:
                set_in(self.params, d + ("conv2", "kernel"), t2f_conv3d(w))
            self.plain_bn(sd, f"{src}.bn2", d + ("bn2",))

        # encoder: layers_down.0 = blocks only; layers_down.i>=1 =
        # [conv,bn,drop,relu] + blocks
        layers_down = [1, 2, 3, 4]
        for b in range(layers_down[0]):
            block(f"{prefix}layers_down.0.{b}", dst0 + (f"down0_block{b}",))
        for i in range(1, 4):
            src = f"{prefix}layers_down.{i}"
            w = sd.get(f"{src}.0.weight")
            if w is not None:
                set_in(self.params,
                       dst0 + (f"down{i}_stride", "conv", "kernel"),
                       t2f_conv3d(w))
            self.plain_bn(sd, f"{src}.1",
                          dst0 + (f"down{i}_stride", "norm"))
            for b in range(layers_down[i]):
                block(f"{src}.{4 + b}", dst0 + (f"down{i}_block{b}",))
        # decoder
        layers_up = [3, 2, 1]
        for i in range(3):
            w = sd.get(f"{prefix}layers_up_conv.{i}.weight")
            if w is not None:
                set_in(self.params, dst0 + (f"up{i + 1}_conv", "kernel"),
                       t2f_conv3d(w))
            w = sd.get(f"{prefix}proj.{i}.conv.weight")
            if w is not None:
                set_in(self.params, dst0 + (f"up{i + 1}_proj", "kernel"),
                       t2f_conv3d(w))
            self.plain_bn(sd, f"{prefix}proj.{i}.norm",
                          dst0 + (f"up{i + 1}_proj_norm",))
            for b in range(layers_up[i]):
                block(f"{prefix}layers_up_res.{i}.{b}",
                      dst0 + (f"up{i + 1}_block{b}",))

    def convert_tsdf_head(self, sd, prefix="tsdf_head."):
        for i in range(3):
            w = sd.get(f"{prefix}decoders.{i}.weight")
            if w is not None:
                set_in(self.params,
                       ("tsdf_head", f"decoder{i}", "kernel"),
                       t2f_conv3d(w))

    def convert_detection(self, sd, bprefix="detection_backbone.",
                          hprefix="detection_head."):
        det = ("detector",)
        bb = det + ("backbone",)
        # stem: conv1.0 = MEConv, conv1.1 = InstanceNorm (scale/bias only)
        self.me_kernel(sd, f"{bprefix}conv1.0", bb + ("stem",))
        if f"{bprefix}conv1.1.weight" in sd:
            set_in(self.params, bb + ("stem", "norm", "scale"),
                   sd[f"{bprefix}conv1.1.weight"])
            set_in(self.params, bb + ("stem", "norm", "bias"),
                   sd[f"{bprefix}conv1.1.bias"])
        layers = [3, 4, 6, 3]
        for li, n in enumerate(layers):
            for b in range(n):
                base = f"{bprefix}layer{li + 1}.{b}"
                dst = bb + (f"layer{li + 1}_block{b}",)
                for conv, norm in (("conv1", "norm1"), ("conv2", "norm2")):
                    self.me_kernel(sd, f"{base}.{conv}", dst + (conv,))
                    self.plain_bn(sd, f"{base}.{norm}",
                                  dst + (conv, "norm"))
                self.me_kernel(sd, f"{base}.downsample.0",
                               dst + ("downsample",))
                self.plain_bn(sd, f"{base}.downsample.1.bn",
                              dst + ("downsample", "norm")) or \
                    self.plain_bn(sd, f"{base}.downsample.1",
                                  dst + ("downsample", "norm"))
        head = det + ("head",)
        for i in range(1, 4):
            base = f"{hprefix}up_block_{i}"
            dst = head + (f"up_block_{i}",)
            self.me_kernel(sd, f"{base}.0", dst, name="up_kernel")
            self.plain_bn(sd, f"{base}.1.bn", dst + ("norm1",))
            self.me_kernel(sd, f"{base}.3", dst + ("conv",))
            self.plain_bn(sd, f"{base}.4.bn", dst + ("conv", "norm"))
        for i in range(4):
            base = f"{hprefix}out_block_{i}"
            dst = head + (f"out_block_{i}",)
            self.me_kernel(sd, f"{base}.0", dst)
            self.plain_bn(sd, f"{base}.1.bn", dst + ("norm",))
        for name in ("centerness_conv", "reg_conv", "cls_conv"):
            self.me_kernel(sd, f"{hprefix}{name}", head, name=name)
        if f"{hprefix}cls_conv.bias" in sd:
            set_in(self.params, head + ("cls_bias",),
                   sd[f"{hprefix}cls_conv.bias"])
            self._get(head).pop("cls_conv_bias", None)
        for i in range(4):
            w = sd.get(f"{hprefix}scales.{i}.scale")
            if w is not None:
                set_in(self.params, head + (f"scale_{i}",),
                       np.asarray(w).reshape(()))

    def _get(self, path):
        node = self.params
        for k in path:
            node = node.setdefault(k, {})
        return node


def convert_state_dict(sd, me_offset_order="xyz"):
    sd = {k: np.asarray(v) for k, v in sd.items()}
    c = Converter(me_offset_order)
    if any(k.startswith("bottom_up.") for k in sd):
        # bare R-50 FPN checkpoint (loaded inside FPN in the reference)
        c.convert_2d_tower(sd, prefix="")
    else:
        c.convert_2d_tower(sd, prefix="fpn.")
        c.convert_fuse(sd)
        c.convert_unet3d(sd)
        c.convert_tsdf_head(sd)
        c.convert_detection(sd)
    return c.params, c.stats



def read_pth(path: str) -> Dict[str, np.ndarray]:
    """A reference ``.pth`` (a state dict, or a checkpoint holding one under
    ``state_dict``) -> its tensors as numpy arrays."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    return {k: v.numpy() for k, v in sd.items() if hasattr(v, "numpy")}


def reference_state_dict(sd, me_offset_order: str = "xyz",
                         module: nn.Module = None
                         ) -> Dict[str, torch.Tensor]:
    """A reference state dict (numpy or torch tensors) -> the port's state
    dict: ``bridge.from_flax`` of ``convert_state_dict``.  With ``module``,
    the keys must be exactly the module's (``from_flax`` raises
    otherwise)."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    params, stats = convert_state_dict(sd, me_offset_order)
    return from_flax({"params": params, "batch_stats": stats}, module)


def load_pretrained_2d(model: nn.Module, path: str,
                       me_offset_order: str = "xyz") -> int:
    """Copy the tensors of a reference ``.pth`` (the R-50 of
    ``backbone2d.pretrained``) into ``model`` where the port has them, as
    ``tools/train.py`` merges them: a tensor with no target is skipped
    with a message, a shape that differs raises.  Returns the number of
    tensors copied."""
    state = reference_state_dict(read_pth(path), me_offset_order)
    own = model.state_dict()
    n = 0
    with torch.no_grad():
        for key, value in state.items():
            if key not in own:
                print(f"pretrained: no target for {key} (skipped)")
                continue
            if tuple(own[key].shape) != tuple(value.shape):
                raise ValueError(f"pretrained shape mismatch at {key}: "
                                 f"{tuple(own[key].shape)} vs "
                                 f"{tuple(value.shape)}")
            own[key].copy_(value)
            n += 1
    return n
