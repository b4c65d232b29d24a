"""Stacked-LSTM text classification (reference: book understand_sentiment
stacked_lstm_net and the RNN benchmark benchmark/paddle/rnn/rnn.py —
the "LSTM text-cls" row of BASELINE.md)."""

from __future__ import annotations

from .. import layers

__all__ = ["stacked_lstm_net", "conv_net"]


def stacked_lstm_net(data, vocab_size, class_dim=2, emb_dim=128,
                     hid_dim=512, stacked_num=3):
    """data: int64 token ids, lod_level=1 (padded [B, T] + lengths).

    Alternating-direction stacked LSTMs, max-pool over time of the last
    pair, softmax head — per the reference book model. Each fc feeding an
    LSTM is the 4x gate projection done as one large GEMM.
    """
    assert stacked_num % 2 == 1
    emb = layers.embedding(input=data, size=[vocab_size, emb_dim])
    fc1 = layers.fc(input=emb, size=hid_dim * 4)
    lstm1, cell1 = layers.dynamic_lstm(input=fc1, size=hid_dim * 4)

    inputs = [fc1, lstm1]
    for i in range(2, stacked_num + 1):
        fc = layers.fc(input=inputs, size=hid_dim * 4)
        lstm, cell = layers.dynamic_lstm(input=fc, size=hid_dim * 4,
                                         is_reverse=(i % 2) == 0)
        inputs = [fc, lstm]

    fc_last = layers.sequence_pool(input=inputs[0], pool_type="max")
    lstm_last = layers.sequence_pool(input=inputs[1], pool_type="max")
    return layers.fc(input=[fc_last, lstm_last], size=class_dim,
                     act="softmax")


def conv_net(data, vocab_size, class_dim=2, emb_dim=128, hid_dim=128):
    """The book's sequence_conv_pool sentiment variant."""
    from .. import nets
    emb = layers.embedding(input=data, size=[vocab_size, emb_dim])
    conv3 = nets.sequence_conv_pool(input=emb, num_filters=hid_dim,
                                    filter_size=3, act="tanh",
                                    pool_type="max")
    conv4 = nets.sequence_conv_pool(input=emb, num_filters=hid_dim,
                                    filter_size=4, act="tanh",
                                    pool_type="max")
    return layers.fc(input=[conv3, conv4], size=class_dim, act="softmax")
