"""AlexNet (paper Table 1), torchvision layout, 3x256x256 inputs."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="alexnet", family="cnn", n_layers=5, d_model=0, n_heads=0, n_kv=0,
    d_ff=0, vocab=0, cnn_arch="alexnet", img_size=256, n_classes=1000)
