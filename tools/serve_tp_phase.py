"""Phase 19 or 20 of ``chip_smoke.py`` alone on one CUDA card: serving
under ``model`` (19), or parameters split over ``data`` (20: ZeRO-3 and
the MoE shard modes), on four gloo ranks sharing ``cuda:0`` against the
mesh-less steps, and the dry run's plans of the ranks' programs against
them.

From the repository root:

    python3 tools/serve_tp_phase.py [19|20]

It builds the attention and RG-LRU kernel sources, runs
``chip_smoke.phase_serve_tp`` (19, the default) or
``chip_smoke.phase_fsdp`` (20) (its report lines go to standard output)
and writes the phase's results to ``chiprun_out/phase<N>.json``; any
failed check raises.
"""

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402


def main() -> int:
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.rglru import kernel as RK
    if not torch.cuda.is_available():
        print("serve_tp_phase: no CUDA device available", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(build.build, (FK.SOURCE, RK.SOURCE)))
    FK._library()
    RK._library()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0].strip()
    phase = sys.argv[1] if len(sys.argv) > 1 else "19"
    run = {"19": chip_smoke.phase_serve_tp, "20": chip_smoke.phase_fsdp}
    out = run[phase](torch.device("cuda"), smi)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / f"phase{phase}.json").write_text(json.dumps(out, default=str,
                                                        indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
