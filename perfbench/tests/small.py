"""Cells at sizes the CPU holds (``cell_patch`` of `run.run_cell`)."""


def small_sync(cell, config):
    """The LeNet cells at 16 satellites, 10 rounds."""
    config["fleet"].update(num_clients=16, num_planes=4, sats_per_plane=4)
    config["fl"].update(samples_per_client=32, batch_size=8, eval_size=512)
    cell["traffic"].update(rounds=10, compare_rounds=10, check_among=1)


def small_moe(cell, config):
    """The Mixtral cell at the program's smoke widths, one layer."""
    config["variant"] = "smoke"
    config["model"].update(num_layers=1, d_model=256, num_heads=4,
                           num_kv_heads=4, head_dim=32, d_ff=512,
                           vocab_size=512, num_experts=4, window_size=64)
    config["fl"].update(seq_len=96, global_batch=8)
    config["profile"].update(grad_accum=4)

