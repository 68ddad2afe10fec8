"""Hand-written Hopper kernels and their plain PyTorch versions.

Each wrapper takes its plain version for a tensor on the CPU only; for a CUDA
tensor it launches its kernel or raises. Each wrapper carries an integer
``launches`` attribute, incremented once per kernel launch.
"""

import torch


class NoBackward(torch.autograd.Function):
    """Run a kernel launch as an autograd node whose backward raises.

    The kernels have no backward yet. A launch that wrote into a fresh tensor
    would otherwise cut the graph silently, and training would run on wrong
    gradients; with this node the forward works in any grad mode and a
    backward through the kernel fails loudly.
    """

    @staticmethod
    def forward(ctx, name, launch, *inputs):
        ctx.name = name
        return launch(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(f"{ctx.name} has no backward kernel: gradients through it "
                                  "come with the training slice of the port")
