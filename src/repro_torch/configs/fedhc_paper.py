"""Paper-experiment presets (§IV-A): LeNet, SGD lr 0.01, batch 64, K = 4,
MNIST-like and CIFAR-like, on the port's :class:`FLRunConfig`.

Counterpart of ``repro/configs/fedhc_paper.py``, field for field.
"""
from repro_torch.core.fedhc import FLRunConfig
from repro_torch.data.synthetic import CIFAR_LIKE, MNIST_LIKE

MNIST_K4 = FLRunConfig(method="fedhc", num_clients=32, num_clusters=4,
                       rounds=300, rounds_per_global=5, local_steps=2,
                       batch_size=64, lr=0.01, dataset=MNIST_LIKE)
CIFAR_K4 = FLRunConfig(method="fedhc", num_clients=32, num_clusters=4,
                       rounds=1000, rounds_per_global=5, local_steps=2,
                       batch_size=64, lr=0.01, dataset=CIFAR_LIKE)

# converged target accuracies of Table I (paper §IV-B)
TARGETS = {"mnist-like": 0.80, "cifar-like": 0.40}
