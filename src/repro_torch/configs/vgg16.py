"""VGG16 (paper Table 1), torchvision layout, 3x256x256 inputs."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="vgg16", family="cnn", n_layers=13, d_model=0, n_heads=0, n_kv=0,
    d_ff=0, vocab=0, cnn_arch="vgg16", img_size=256, n_classes=1000)
