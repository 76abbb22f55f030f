"""``snake_sandwich``: BigVGAN's anti-aliased SnakeBeta (2x up, snake, 2x
down) in one launch (``csrc/sandwich.cu``), 109 a vocode of the 22 kHz
80-band generator; a request vocodes its first clip."""

from .geometry import per_unit, sandwich_cost, sandwich_geometries

LAUNCH = "snake_sandwich"
PATTERNS = ("snake_sandwich_kernel",)
PEAK = "fp32"


def launches(cell):
    if not cell.traffic.get("vocode"):
        return []
    voc = [sandwich_cost(1, t, c)
           for _, t, c, uses in sandwich_geometries(cell.config["vocoder"],
                                                    int(cell.traffic["mel_t"]))
           for _ in range(uses)]
    return per_unit(cell, per_vocode=voc)
