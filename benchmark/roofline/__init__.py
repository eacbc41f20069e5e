"""The yardstick's arithmetic: each kernel's or step's operations and
bytes, computed from its shapes (`k1`, `k3`, `prime_dual`,
`coupled_vae`), and the published peaks of the cards (`peaks.json`)."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

_PEAKS = Path(__file__).resolve().parent / 'peaks.json'


def peaks(kind: str) -> Optional[dict]:
    """The published peaks of the card named `kind`
    (`torch.cuda.get_device_name()`), or None for a card not listed."""
    with open(_PEAKS) as f:
        return json.load(f)['cards'].get(kind)
