"""Device functions and op lowerings of the port.

Kernels with their wrappers and plain versions: flash attention K1-K4
(flash_attention.py), the lm-head log-sum-exp K5 (chunked_ce.py) and
the int8 matmul K6 (quant_ops.py). The stacked transformer (the
training op, the generation ops and the LM server's KV-cached
functions): transformer_ops.py. The sequence (LoD) programs: the masked
sequence ops (sequence_ops.py), the recurrences as time loops
(rnn_ops.py) and beam search (beam_ops.py), all plain torch. The
evaluators' in-graph histogram, AUC and chunk-count ops: metric_ops.py.
The sub-block ops (while, ifelse, switch, the tensor arrays:
control_flow_ops.py; recurrent_group: rnn_group_ops.py), CTC
(ctc_ops.py), the linear-chain CRF (crf_ops.py) and misc_ops.py, all
plain torch. The SSD op set (detection_ops.py: priors, IoU, box coding,
matching, NMS, hard-negative mining) and roi_pool (vision_ops.py), plain
torch as well. The op
registry, the autograd tape and the lowerings the programs run:
registry.py, grad.py, math_ops.py, nn_ops.py, tensor_ops.py,
attention_ops.py, chunked_ce.py, optimizer_ops.py, quant_ops.py,
transformer_ops.py, sequence_ops.py, rnn_ops.py, beam_ops.py,
metric_ops.py, control_flow_ops.py, rnn_group_ops.py, ctc_ops.py,
crf_ops.py, misc_ops.py, detection_ops.py, vision_ops.py — imported
here so that every lowering is registered. The wrappers' launch counts: launch_counts.py.
"""

from . import registry  # noqa: F401
from . import (attention_ops, chunked_ce, math_ops, nn_ops,  # noqa: F401
               optimizer_ops, quant_ops, tensor_ops, transformer_ops)
from . import beam_ops, metric_ops, rnn_ops, sequence_ops  # noqa: F401
from . import (control_flow_ops, crf_ops, ctc_ops, misc_ops,  # noqa: F401
               rnn_group_ops)
from . import detection_ops, vision_ops  # noqa: F401
