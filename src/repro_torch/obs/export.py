"""Summary artifact for ``--trace-dir`` (port of ``repro.obs.export.write_summary``).

The reference's document bundles collective counters, a residual rollup
and launcher extras; the port writes the counters (a
`repro_torch.obs.MetricsRegistry`, when given) and the extras (the
residual rollup needs ``obs.residuals``, not ported yet).
"""
from __future__ import annotations

import json
from typing import Dict, Optional


def write_summary(path: str, *, counters=None,
                  extra: Optional[Dict] = None) -> None:
    out: Dict = {}
    if counters is not None:
        out["counters"] = counters.to_json()
    if extra:
        out.update(extra)
    with open(path, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
