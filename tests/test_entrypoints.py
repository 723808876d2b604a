"""Entry points must keep working: __graft_entry__, the bench frame
construction (compile-checked on CPU; measured on the GPU) and the
measurement scripts' refusal to run without a GPU."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


class TestGraftEntry:
    def test_entry_compiles_and_runs(self):
        import __graft_entry__ as g

        fn, args = g.entry()
        out = jax.block_until_ready(jax.jit(fn)(*args))
        positions, heights, count = out
        assert positions.ndim == 3 and positions.shape[-1] == 3
        assert heights.shape == positions.shape[:2]
        assert int(count) > 0
        assert not np.isnan(np.asarray(positions)).any()

    def test_dryrun_multichip(self):
        import __graft_entry__ as g

        g.dryrun_multichip(min(8, len(jax.devices())))


class TestBenchPath:
    def test_bench_frame_builds(self):
        """bench.build_frame compiles and produces the headline frame:
        the culled 60-degree view of the 8k^2 terrain, no overflow, a
        finite (capacity, 17, 17, 3) vertex grid (a smaller atlas keeps
        the random block store small)."""
        import bench

        frame, args, cfg = bench.build_frame(atlas_slots=64)
        tiles, mesh = jax.block_until_ready(frame(*args))
        n = int(tiles.tile_count)
        assert 1000 < n <= cfg.tile_capacity
        assert int(tiles.overflow) == 0
        assert mesh.positions.shape == (cfg.tile_capacity, 17, 17, 3)
        assert np.isfinite(np.asarray(mesh.positions[:n])).all()

    def test_bench_main_refuses_cpu(self, capsys):
        import bench

        with pytest.raises(SystemExit) as exc:
            bench.main()
        assert exc.value.code not in (0, None)
        assert '"metric"' not in capsys.readouterr().out


class TestChipSmoke:
    def test_refuses_cpu_backend(self):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        out = subprocess.run(
            [sys.executable, str(REPO / "chip_smoke.py")], env=env,
            capture_output=True, text=True, timeout=300, cwd=REPO,
        )
        assert out.returncode != 0
        assert '"ok"' not in out.stdout

    def test_phases_rehearse_on_cpu(self, tmp_path):
        """The planar and Earth phases at the tiny rehearsal size, with
        the CPU as both the device and the reference: streaming,
        preprocess byte-identity, the per-vertex reference and the
        node-set/deep-subset comparisons all run."""
        import chip_smoke as cs

        cpu = jax.devices("cpu")[0]
        s = dict(cs.TINY, frames=1)
        _, out, _ = cs.phase_planar(tmp_path, s, 0, cpu, expect_device=False)
        assert out.overflow == 0 and out.tile_count > 0
        cs.phase_earth(tmp_path, s, 0, cpu)

    def test_shared_edges_drawn_once(self):
        import chip_smoke as cs

        cs.shared_edges_once()

    def test_four_card_path_on_virtual_devices(self, tmp_path):
        import chip_smoke as cs

        if len(jax.devices()) < 4:
            pytest.skip("needs 4 virtual devices")
        cs.phase_four_cards(tmp_path, dict(cs.TINY, frames=1), 0,
                            jax.devices()[:4])


class TestNoTpuCode:
    def test_no_tpu_imports_or_branches(self):
        """Nothing in the package, the tools or the entry scripts imports
        the TPU Pallas dialect or branches on a TPU backend."""
        files = [*REPO.glob("bevy_terrain_tpu/**/*.py"),
                 *REPO.glob("tools/*.py"), REPO / "bench.py",
                 REPO / "chip_smoke.py", REPO / "__graft_entry__.py"]
        banned = ("pallas.tpu", "pltpu", 'default_backend() == "tpu"',
                  "default_backend() == 'tpu'", "block_format",
                  "pallas_sampling", "generate_mesh_fused")
        hits = [f"{f.relative_to(REPO)}: {b}" for f in files
                for b in banned if b in f.read_text()]
        assert not hits, hits
