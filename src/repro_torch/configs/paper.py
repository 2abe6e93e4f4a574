"""The paper's own evaluation applications (§4): GNMT + ResNet-18 (port of
``repro.configs.paper``), profiled on an 8-way data-parallel mesh and
trained on one card."""
from repro_torch.models.gnmt import GNMT
from repro_torch.models.resnet import ResNet18


def gnmt_model(vocab: int = 4096, d: int = 256, layers: int = 2) -> GNMT:
    return GNMT(vocab=vocab, d=d, layers=layers)


def resnet18_model(num_classes: int = 200) -> ResNet18:
    return ResNet18(num_classes=num_classes)


GNMT_DATA = dict(vocab_size=4096, src_len=48, tgt_len=48, global_batch=32)
RESNET_DATA = dict(num_classes=200, global_batch=64, image_size=64)
