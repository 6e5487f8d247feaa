"""``step_mfu.train``: the whole train step's share of the card's peak in
the configuration's compute dtype, in %: the model's operations a image
(``perfbench.counts.bounds.resnet_sq_train_flops``) × the images of the
window ÷ its seconds ÷ the cell's chips ÷ the peak."""


def read(record):
    if not record.get("images") or "flops_per_image" not in record:
        return None
    rate = record["images"] / record["window_s"] / record["chips"]
    return 100.0 * record["flops_per_image"] * rate / record["peak_flops"]
