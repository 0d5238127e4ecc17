"""The served forward's share of the card's dense bf16 peak: the
reference's forward operations per image (``torch.utils.flop_counter`` at
the cell's shapes, written in the configuration), times the images
answered a second in the run's window, over 989 TFLOP/s. Padded slots
compute too and are not counted."""

from portbench.costs import BF16_FLOPS_PER_S

UNIT, LAYER, MOVES = "%", "predictor", "serve_img_per_s"


def read(r):
    if r.kind != "serve" or r.rate <= 0:
        return None
    return 100.0 * r.config["flops_per_image"]["forward"] * r.rate / (BF16_FLOPS_PER_S * r.chips)
