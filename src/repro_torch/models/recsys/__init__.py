"""RecSys of the port: DIN (Deep Interest Network)."""

from repro_torch.models.recsys import din
