"""Mid-plane overlay plot of a dumped solution against the analytic one.

The counterpart of the JAX package's ``scripts/plotter.py`` (itself the
reference's plotter.py), on the port's ``utils/dump.py``: loads a
``Vector3::dump`` text file (``--dump PATH`` on the CLI), slices the
mid-plane ``x = dim_x // 2`` and draws the solved surface over the exact
solution ``u = (x-x²)(y-y²)(z-z²)`` of the nonlinear problem, with the
absolute error beside it.

    python -m gpusolve_tpu_torch.scripts.plotter DUMPFILE [-o out.png]

With no ``-o`` it writes ``DUMPFILE.png`` beside the input.  It needs
matplotlib, imported when it runs; without it the script says so and
exits 1.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from gpusolve_tpu_torch.utils.dump import analytic_solution, load_dump


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dump", help="Vector3::dump-format text file")
    ap.add_argument("-o", "--out", default=None, help="output image path")
    args = ap.parse_args(argv)

    try:
        import matplotlib
    except ImportError:
        print("plotter: matplotlib is not installed here; the plot needs "
              "it", file=sys.stderr)
        return 1
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    mesh = load_dump(args.dump)
    # h = 1/(dimY+1) with the padded dump extents: 1/(shape[1]-1).
    h = 1.0 / (mesh.shape[1] - 1)
    exact = analytic_solution(mesh.shape, h)

    xmid = mesh.shape[0] // 2
    ny, nz = mesh.shape[1], mesh.shape[2]
    Y, Z = np.meshgrid(np.arange(ny) * h, np.arange(nz) * h, indexing="ij")

    fig = plt.figure(figsize=(12, 5))
    ax1 = fig.add_subplot(1, 2, 1, projection="3d")
    ax1.plot_wireframe(Y, Z, mesh[xmid], rstride=4, cstride=4,
                       color="tab:blue", label="solved")
    ax1.plot_wireframe(Y, Z, exact[xmid], rstride=4, cstride=4,
                       color="tab:orange", alpha=0.6, label="analytic")
    ax1.set_title(f"mid-plane x={xmid} overlay")
    ax1.set_xlabel("y")
    ax1.set_ylabel("z")
    ax1.legend()

    ax2 = fig.add_subplot(1, 2, 2)
    err = np.abs(mesh[xmid] - exact[xmid])
    im = ax2.imshow(err, origin="lower",
                    extent=[0.0, (nz - 1) * h, 0.0, (ny - 1) * h])
    ax2.set_title(f"abs error (max {err.max():.3g})")
    ax2.set_xlabel("z")
    ax2.set_ylabel("y")
    fig.colorbar(im, ax=ax2)

    out = args.out or args.dump + ".png"
    fig.savefig(out, dpi=110, bbox_inches="tight")
    plt.close(fig)
    print(f"wrote {out} (max-abs mid-plane error {err.max():.6g})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
