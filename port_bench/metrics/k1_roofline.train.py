"""K1's share of its roofline in the training cell: the forward launches, one
a layer a step, on (batch, heads, frames, head dim) with each row's valid
frames as its keys, bound over K1's device time, in %. The backward runs the
plain version and is not K1's. Moves train_frames_per_s."""

from port_bench.yardstick import kernels, readers


def read(run):
    fm, tr = run.config["flow_matching"], run.traffic
    heads, head_dim = fm["heads"], fm["hidden_size"] // fm["heads"]
    bound = sum(fm["depth"] * kernels.k1_bound_s(tr["batch_size"], heads, tr["frames_per_seg"], head_dim, [valid])
                for valid in run.records.get("valid_keys", []))
    return readers.roofline(run, bound, (kernels.K1,))
