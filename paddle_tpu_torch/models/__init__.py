"""The port's models: the GPT-2 decoder-only LM (transformer.py), the
image classifiers (mnist.py, resnet.py, vgg.py, alexnet.py,
googlenet.py), the sequence models (seq2seq.py, lstm_text.py,
word2vec.py, recommender.py), the CTR models (ctr.py) and the CRNN-CTC
OCR model (ocr.py), each function
writing the same Program as the JAX package's function of the same
name."""

from . import (alexnet, ctr, googlenet, lstm_text, mnist,  # noqa: F401
               ocr, recommender, resnet, seq2seq, transformer, vgg,
               word2vec)
