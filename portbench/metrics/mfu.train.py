"""The whole train step's share of the cards' dense bf16 peak: the
reference's operations per trained image (forward and backward, counted
with ``torch.utils.flop_counter`` at the cell's shapes and written in the
configuration), times the images a second of the run's window, over 989
TFLOP/s a card."""

from portbench.costs import BF16_FLOPS_PER_S

UNIT, LAYER, MOVES = "%", "train step", "train_img_per_s"


def read(r):
    if r.kind != "train" or r.rate <= 0:
        return None
    flops = r.config["flops_per_image"]["train"]
    return 100.0 * flops * r.rate / (BF16_FLOPS_PER_S * r.chips)
