"""Position-wise feed-forward (port of masr_tpu/models/positionwise.py)."""
from torch import nn

from masr_tpu_torch.ops.common import dropout


class PositionwiseFeedForward(nn.Module):
    """w_1 → activation → dropout (training) → w_2."""

    def __init__(self, idim: int, hidden_units: int, activation,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.w_1 = nn.Linear(idim, hidden_units)
        self.w_2 = nn.Linear(hidden_units, idim)
        self.activation = activation
        self.dropout_rate = dropout_rate

    def forward(self, x, generator=None):
        h = dropout(self.activation(self.w_1(x)), self.dropout_rate,
                    self.training, generator)
        return self.w_2(h)
