"""End-to-end demo of the PyTorch/CUDA port: synthetic feed -> flagship +
v7.57 analytics (counterpart of `examples/demo.py`).

Run: python examples/demo_torch.py                 (on the card)
     python examples/demo_torch.py --device cpu    (without one)
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    parser.add_argument("--window", type=int, default=4096, help="analysis window in bars")
    args = parser.parse_args(argv)

    from wavespec_tpu_torch import models
    from wavespec_tpu_torch.testing import planted_cycles

    series, cycles = planted_cycles(
        6000, [(2.5, 48.0, 0.4), (1.2, 130.0, 1.1)],
        noise=0.05, drift=0.02, level=100.0, seed=7,
    )
    print(f"series: {len(series)} bars; planted periods "
          f"{[c.period for c in cycles]}; device {args.device}")

    out = models.flagship(window=args.window, hop=8, device=args.device).run(series)
    last = out["attrs"][-1].cpu().numpy()
    print("\nflagship (1.1.0, MUSIC) newest-window cycles:")
    for row in last:
        if row[0] > 0:
            print(f"  period {row[2]:7.2f} bars  amp {row[0]:6.3f}  "
                  f"eta {row[4]:5.1f} bars  snr {row[8]:5.1f} dB")

    v = models.v757(window=args.window, hop=8, device=args.device, min_period=18.0,
                    max_period=200.0)
    vout = {k: t.cpu().numpy() for k, t in v.run(series).items()}
    periods, active = vout["slot_period"][-1], vout["slot_valid"][-1]
    print(f"\nv7.57 slots (newest frame): "
          f"{[round(float(p), 1) for p, a in zip(periods, active) if a]}")
    print(f"v7.57 FollowFirst signals fired: {int((abs(vout['sig']) > 0).sum())}")
    print(f"v7.57 Kalman price estimate: {vout['kalman'][-1]:.3f} "
          f"(actual {series[-1]:.3f})")
    return {"attrs": last, "v757": vout}


if __name__ == "__main__":
    main()
