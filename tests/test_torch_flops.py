"""The port's FLOP count (`utils/flops.py`) against the JAX package's: the
same forward and training FLOPs per image on the zoo nets, the same peak
on the TPU device kinds, and the H100's dense bf16 peak from NVIDIA's
datasheet beside them."""
import pytest

from sparknet_tpu import zoo as jax_zoo
from sparknet_tpu.model.net import CompiledNet as JaxCompiledNet
from sparknet_tpu.utils import flops as jax_flops

from sparknet_tpu_torch import zoo
from sparknet_tpu_torch.model.net import CompiledNet
from sparknet_tpu_torch.utils import flops

NETS = {
    "caffenet": lambda z: z.caffenet(batch=2, crop=227, n_classes=1000),
    "cifar10_quick": lambda z: z.cifar10_quick(batch=2),
    "lenet": lambda z: z.lenet(batch=2),
    "adult_mlp": lambda z: z.adult_mlp(batch=2),
}


@pytest.mark.parametrize("name", sorted(NETS))
def test_the_counts_are_the_jax_package_s(name):
    net = CompiledNet.compile(NETS[name](zoo))
    jnet = JaxCompiledNet.compile(NETS[name](jax_zoo))
    fwd = flops.forward_flops_per_image(net)
    assert fwd > 0
    assert fwd == jax_flops.forward_flops_per_image(jnet)
    assert flops.train_flops_per_image(net) == \
        jax_flops.train_flops_per_image(jnet) == 3.0 * fwd
    assert flops.TRAIN_FWD_MULT == jax_flops.TRAIN_FWD_MULT


def test_caffenet_s_forward_is_its_published_size():
    # conv1 105.4M MACs ... fc8 4.1M: about 0.72 GMACs (1.45 GFLOPs) an
    # image at 227 and 1000 classes
    net = CompiledNet.compile(zoo.caffenet(batch=1, crop=227,
                                           n_classes=1000))
    assert 1.4e9 < flops.forward_flops_per_image(net) < 1.5e9


@pytest.mark.parametrize("kind", ["TPU v6 lite", "TPU v5p", "TPU v5 lite",
                                  "TPU v5e", "TPU v4", "TPU v3", "TPU v2"])
def test_the_tpu_rows_are_the_jax_package_s(kind):
    assert flops.peak_bf16_flops(kind) == jax_flops.peak_bf16_flops(kind)
    assert flops.peak_bf16_flops(kind) > 0


def test_the_h100_rows_and_an_unknown_name():
    assert flops.peak_bf16_flops("NVIDIA H100 80GB HBM3") == 989.4e12
    assert flops.peak_bf16_flops("NVIDIA H100 PCIe") == 756e12
    for unknown in ("NVIDIA A100-SXM4-80GB", "cpu", ""):
        assert flops.peak_bf16_flops(unknown) == 0.0
