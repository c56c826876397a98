"""CPU oracles: NumPy reference implementations the port is held to.

The port's own copies of the JAX package's oracles (the analog of the
reference's ``src/utils.h`` CPU oracle): ``attention`` (``mulmat_ref``,
``softmax_ref``, ``online_softmax_ref``, ``attention_ref``), ``quant``
(the GGML block formats and the per-row KV codecs, as ``quant_ref``) and
``model`` (the full-model forward and perplexity).
"""

from ggml_cuda_experiments_tpu_torch.oracle.attention import (
    attention_ref,
    mulmat_ref,
    online_softmax_ref,
    softmax_ref,
)
from ggml_cuda_experiments_tpu_torch.oracle import quant as quant_ref
