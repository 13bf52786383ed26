"""Medium shader-parameter row (host side).

Counterpart of the constant and the numpy helper of ignis_tpu/medium/volume.py
that the scene compiler needs for every scene; grids, lookups and the point
mapper are not ported yet.
"""

from __future__ import annotations

import numpy as np

SHADER_ROW = 20


def shader_row_from_props(mobj: dict) -> np.ndarray:
    """Build the shader-parameter row from medium JSON properties
    (HeterogeneousMedium.cpp:92-153 parameter defaults)."""
    def num(k, dv):
        return float(mobj.get(k, dv))

    def col(k, dv):
        v = mobj.get(k, dv)
        if isinstance(v, (int, float)):
            v = [v, v, v]
        return np.asarray(v[:3], np.float32)

    row = np.zeros(SHADER_ROW, np.float32)
    row[0] = num("scalar_density", 1.0)
    row[1] = num("scalar_emission", 0.0)
    shader = mobj.get("shader", "monochromatic")
    if shader == "principled_volume":
        row[2:5] = col("color_scattering", [0.5, 0.5, 0.5])
        row[5:8] = col("color_absorption", [0.8, 0.8, 0.8])
    else:
        row[2:5] = col("color_scattering", [1.0, 1.0, 1.0])
        row[5:8] = col("color_absorption", [1.0, 1.0, 1.0])
    row[8:11] = col("color_emission", [1.0, 1.0, 1.0])
    row[11:14] = col("color_blackbody", [0.0, 0.0, 0.0])
    row[14] = min(max(num("scalar_blackbody", 1.0), 0.0), 1.0)
    row[15] = num("scalar_temperature", 0.0)
    cutoff = num("cutoff_temperature", 0.0)
    row[16] = num("offset_temperature", cutoff)
    row[17] = num("scalar_absorption", 1.0)
    row[18] = num("scalar_scattering", 1.0)
    return row
