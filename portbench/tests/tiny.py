"""Tiny configurations and traffic for the CPU tests: the cells' shapes cut
to what a CPU test can hold.  The program runs them in float32 here, so that
it agrees with the f32 references to rounding; bf16, the precision below,
is the planted control."""

import copy

DECODER = {
    "family": "decoder", "hidden_size": 64, "intermediate_size": 128,
    "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
    "num_hidden_layers": 2, "vocab_size": 256, "rope_theta": 1e6, "rms_norm_eps": 1e-5,
    "initializer_range": 0.02, "tie_word_embeddings": False,
    "program": {"dtype": "float32", "remat": True, "remat_policy": "full",
                "use_flash_attention": True},
    "training": {"optimizer": "adamw", "learning_rate": 3e-4, "betas": [0.9, 0.999],
                 "eps": 1e-8, "weight_decay": 0.1, "grad_clip_norm": 1.0},
}
DECODER_TRAFFIC = {
    "driver": "decoder_train", "kind": "tokens", "seq_len": 32, "global_batch": 4,
    "pool_batches": 4, "prefetch": 2, "warmup_steps": 3, "reference_steps": 3,
    "limits": {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3},
}
RESNET = {
    "family": "resnet", "stage_sizes": [1, 1, 1, 1], "num_filters": 8, "expansion": 4,
    "num_classes": 10, "image_size": 32,
    "program": {"dtype": "float32", "use_pallas_head": True},
    "training": {"optimizer": "momentum", "nesterov": True, "momentum": 0.9,
                 "learning_rate": 0.1, "weight_decay": 0.0, "label_smoothing": 0.1,
                 "input_stats": [[0.485, 0.456, 0.406], [0.229, 0.224, 0.225]],
                 "steps_per_call": 3, "log_every": 10},
}
RESNET_TRAFFIC = {
    "driver": "resnet_train", "kind": "images", "image_size": 32, "global_batch": 16,
    "pool_batches": 4, "prefetch": 2, "warmup_steps": 3, "reference_steps": 3,
    # The numbers the cells compare; here f32 reads ~1e-4 on the median
    # leaves and up to 3e-3 on the worst, bf16 ~0.03 and 0.2-0.7.
    "limits": {"loss_gap": 1e-4, "trace_median_gap": 3e-3, "change_median_gap": 3e-3,
               "trace_gap": 0.03, "change_gap": 0.03},
}

CASES = {
    "mistral7b-s4096": (DECODER, DECODER_TRAFFIC),
    "resnet50-b256": (RESNET, RESNET_TRAFFIC),
    "resnet50-dp4-b256": (RESNET, RESNET_TRAFFIC),
}


def case(workload: str, dtype: str | None = None):
    cfg, tr = copy.deepcopy(CASES[workload])
    if dtype is not None:
        cfg["program"]["dtype"] = dtype
    return cfg, tr


def run(workload: str, seed: int = 2 ** 31 + 17, dtype: str | None = None, trace=False,
        plant=None):
    import time

    from portbench import harness

    cfg, tr = case(workload, dtype)
    return harness.run_cell(workload, seed, 0.2, trace, time.time(), cpu=True,
                            config_override=cfg, traffic_override=tr, plant=plant)
