"""``python -m repro_torch.obs <trace.json> [--require PROFILE]`` — the
validation CLI (the surface of ``repro_torch.obs.validate``, without
runpy's re-import warning for the submodule)."""
from repro_torch.obs.validate import main

if __name__ == "__main__":
    raise SystemExit(main())
