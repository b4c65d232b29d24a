"""The port's models: the GPT-2 decoder-only LM (transformer.py) and
the image classifiers (mnist.py, resnet.py, vgg.py, alexnet.py,
googlenet.py), each function writing the same Program as the JAX
package's function of the same name."""

from . import alexnet, googlenet, mnist, resnet, transformer, vgg  # noqa: F401
