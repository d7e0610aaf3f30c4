"""Published peaks of the cards the benchmark knows (NVIDIA's data sheet,
SXM part, dense rates at the full 700 W). A share of a peak or a roofline
is stated against these, with the card's power limit printed beside it."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flop_s": 989e12,
        "f32_flop_s": 67e12,
        "hbm_bytes_s": 3.35e12,
    },
}


def peak(kind: str, key: str):
    """The card's peak, or None for a card not in the table."""
    return PEAKS.get(kind, {}).get(key)
