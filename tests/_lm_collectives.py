"""The collectives of one LM training step on a (data, model) (2, 2) mesh,
the port's beside the reference's, for PERF.md: a script, not a test.

The step is the Qwen3-4B smoke config's (float32, remat off, 2 x 24
tokens, `LM_TRAIN_RULES`). The port's is rank 0's own step on meta
tensors over a fake world of 4 (`tests/test_torch_dryrun_sharded.py`
`_step`, whose bytes that file holds to a reckoning by hand); the
reference's is its step jitted on 4 host devices and compiled, counted by
its `analysis/roofline.py` `parse_collectives` (output bytes of each
collective in the per-device HLO). GSPMD picks its own collectives, so
the two are set side by side, not held equal.

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/_lm_collectives.py
"""

import tempfile

import _sharded_cases as C


def main() -> None:
    finish = C.start_reference(["lm-collectives"], tempfile.mkdtemp())
    from test_torch_dryrun_sharded import _step

    count, _, _, _ = _step(C.LM_BATCH)
    ref = finish()["lm-collectives"]
    kinds = sorted(set(count.collectives) | {k.split("/")[1] for k in ref})
    print(f"{'kind':16s} {'port ops':>9s} {'port bytes':>12s} {'ref ops':>8s} {'ref bytes':>12s}")
    for k in kinds:
        print(f"{k:16s} {count.collectives.get(k, 0):9d} "
              f"{int(count.collective_bytes_by_kind.get(k, 0)):12d} "
              f"{int(ref.get(f'count/{k}', 0)):8d} {int(ref.get(f'bytes/{k}', 0)):12d}")
    print(f"{'total':16s} {sum(count.collectives.values()):9d} {int(count.collective_bytes):12d} "
          f"{sum(int(v) for k, v in ref.items() if k.startswith('count/')):8d} "
          f"{sum(int(v) for k, v in ref.items() if k.startswith('bytes/')):12d}")


if __name__ == "__main__":
    main()
