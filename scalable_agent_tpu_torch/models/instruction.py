"""The language-instruction encoder of the deep IMPALA agent.

The counterpart of ``scalable_agent_tpu/models/instruction.py``
(reference: experiment.py:123-146): hashed token ids (``utils/text.py``,
0 = padding) are embedded and run through an LSTM(64) whose carry freezes
past the last real token, so the output is the hidden state at that token
(the reference's length-masked ``dynamic_rnn`` read at ``length - 1``); a
row of padding only gives zeros.

Plain PyTorch, in float32 under either dtype policy: the JAX package
computes it with flax's ``Embed`` and ``OptimizedLSTMCell``, which carry
no dtype there, outside any Pallas kernel.  The freeze is arithmetic,
``m * new + (1 - m) * old``, as the JAX step computes it.  Parameters:
``embed.weight`` [1001, 20] (flax ``Embed``'s initializer, a normal of
variance 1 / 20), ``wi`` [20, 256], ``wh`` [64, 256] and ``b`` [256] in
gate order (i, f, g, o), initialized as the flax cell is; ``convert.py``
maps ``instruction/embed`` and ``instruction/language_lstm/cell`` onto
them.
"""

import math
from typing import Optional

import torch
from torch import nn

from scalable_agent_tpu_torch.models.networks import init_lstm_
from scalable_agent_tpu_torch.utils.text import NUM_HASH_BUCKETS

EMBEDDING_SIZE = 20  # reference: experiment.py:135
LSTM_SIZE = 64  # reference: experiment.py:142


class InstructionEncoder(nn.Module):
    """Input int [N, L] token ids; output float32 [N, ``LSTM_SIZE``]."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        # +1: id 0 is padding; real ids are 1..NUM_HASH_BUCKETS.
        self.embed = torch.nn.utils.skip_init(
            nn.Embedding, NUM_HASH_BUCKETS + 1, EMBEDDING_SIZE)
        with torch.no_grad():
            self.embed.weight.normal_(0.0, 1.0 / math.sqrt(EMBEDDING_SIZE),
                                      generator=generator)
        self.wi = nn.Parameter(torch.empty(EMBEDDING_SIZE, 4 * LSTM_SIZE))
        self.wh = nn.Parameter(torch.empty(LSTM_SIZE, 4 * LSTM_SIZE))
        self.b = nn.Parameter(torch.zeros(4 * LSTM_SIZE))
        init_lstm_(self.wi, self.wh, generator)

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        n, length = token_ids.shape
        hidden = LSTM_SIZE
        mask = (token_ids != 0).float()
        embedding = self.embed(token_ids.long())
        # Every step's input projection in one product.
        projected = (embedding.reshape(n * length, -1) @ self.wi).reshape(
            n, length, 4 * hidden)
        c = h = torch.zeros((n, hidden), device=token_ids.device)
        for t in range(length):
            # The first step's carry is zero: its h.Wh is the bias alone.
            recurrent = self.b if t == 0 else h @ self.wh + self.b
            i, f, g, o = (recurrent + projected[:, t]).split(hidden, dim=-1)
            new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            new_h = torch.sigmoid(o) * torch.tanh(new_c)
            m = mask[:, t, None]
            c = m * new_c + (1.0 - m) * c
            h = m * new_h + (1.0 - m) * h
        return h
