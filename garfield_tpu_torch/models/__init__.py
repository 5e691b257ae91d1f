"""Model zoo of the port (counterpart of ``garfield_tpu/models``): the ResNet
family of the first slice. ``select_model(name, dataset, dtype=...)``
mirrors the JAX selector; the JAX zoo's other models are not ported yet
(ROADMAP Queue A item 12)."""

import torch

from .resnet import ResNet18, ResNet34, ResNet50, ResNet101, ResNet152

__all__ = ["models", "num_classes_dict", "select_model"]

models = {
    "resnet18": ResNet18,
    "resnet34": ResNet34,
    "resnet50": ResNet50,
    "resnet101": ResNet101,
    "resnet152": ResNet152,
}

# The JAX zoo's other entries (garfield_tpu/models/__init__.py).
_UNPORTED = (
    "convnet", "cifarnet", "cnn", "lenet", "inception", "vgg11", "vgg13",
    "vgg16", "vgg19", "preactresnet18", "googlenet", "densenet121",
    "densenet161", "densenet169", "densenet201", "densenet_cifar",
    "resnext29", "resnext29_4x64d", "resnext29_8x64d", "resnext29_32x4d",
    "mobilenet", "mobilenetv2", "dpn26", "dpn92", "shufflenetg2",
    "shufflenetg3", "shufflenetv2", "senet18", "efficientnetb0",
    "regnetx200", "regnetx400", "regnety400", "pnasneta", "pnasnetb",
    "pimanet", "vit_tiny", "gpt_tiny",
)

num_classes_dict = {
    "cifar10": 10,
    "cifar100": 100,
    "mnist": 10,
    "imagenet": 1000,
    "pima": 1,
    "copytask": 10,
}

# Image channels per dataset; the ResNets take image datasets only.
_in_channels = {"cifar10": 3, "cifar100": 3, "mnist": 1, "imagenet": 3}


def select_model(model, dataset, *, dtype=torch.float32):
    """Instantiate a model by name for a dataset (an ``nn.Module`` on the
    CPU with uninitialized parameters; ``models._layers.init_parameters``
    draws them, the trainer's ``init_fn`` does so on its device)."""
    if dataset not in num_classes_dict:
        raise ValueError(
            f"The specified dataset is undefined, available datasets are: "
            f"{sorted(num_classes_dict)}"
        )
    if model in _UNPORTED:
        raise NotImplementedError(
            f"model {model!r} is not ported yet: ROADMAP Queue A item 12 "
            "(the rest of the model zoo)"
        )
    if model not in models:
        raise ValueError(
            f"The specified model is undefined, available models are: "
            f"{sorted(models)}"
        )
    if dataset not in _in_channels:
        raise ValueError(f"{model!r} takes image datasets, not {dataset!r}")
    return models[model](
        num_classes=num_classes_dict[dataset], dtype=dtype,
        in_channels=_in_channels[dataset],
    )
