"""``python -m vggp_tpu_torch.experiments`` — list the port's experiment
entry points."""

EXPERIMENTS = {
    "univariate": "1D model zoo on synthetic data (notebooks 1 & 4)",
    "kronecker": "2D Kronecker zoo on a synthetic field (notebooks 3 & 5)",
    "simtracks": "synthetic satellite tracks over an SSH snapshot (notebook 6)",
    "gulfstream": "Gulf Stream train/val/test + CV sweeps (notebook 61)",
    "northsea": "North Sea SLA gridded products (notebook 7)",
    "spacetime": "3-D lon x lat x time gridded products (beyond-reference)",
    "poisson": "gridded Poisson intensity mapping from count data (beyond-reference)",
    "exceedance": "joint exceedance/extreme functionals via pathwise sampling (beyond-reference)",
    "streaming": "sequential mission assimilation, no refits (beyond-reference)",
    "velocity": "geostrophic velocities from the gridded-gradient product (beyond-reference)",
    "evidence": "Laplace-evidence kernel selection + hyper-marginalized intervals (beyond-reference)",
    "multioutput": "joint ICM dense+sparse mission pair, cross-output transfer (beyond-reference)",
    "multiscale": "sum-of-kernels scale decomposition with per-scale uncertainty (beyond-reference)",
    "parity": "reference-style torch f64 oracle (CPU) beside the port's f32 column",
}

if __name__ == "__main__":
    print("vggp_tpu_torch experiments — run with "
          "`python -m vggp_tpu_torch.experiments.<name>`:\n")
    for name, desc in EXPERIMENTS.items():
        print(f"  {name:<12} {desc}")
    print("\nEach accepts --outdir (default results/torch/<name>) and --device"
          " (cuda unless given, e.g. --device cpu), and all but streaming and"
          " evidence --iters; gulfstream also --cv, --obs-root/--ref-root for the"
          " real archives.")
