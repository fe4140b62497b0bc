"""repro_torch.analysis: the port's lint and its work and wire audits
(port of ``repro/analysis``, DESIGN.md §10), all reporting
``findings.Finding``:

  * ``astlint``      stdlib-ast rules over the port's source (prints in
                     library modules, imports of the reference, devices
                     pinned in public signatures, mutable defaults,
                     tracked bytecode);
  * ``launch_audit`` a round's dispatched ops and kernel launches do not
                     grow with the number of cells (the eager counterpart
                     of the reference's one-compile contract);
  * ``wire_checks``  the bytes by dtype that cross the simulated ring and
                     the process-group ring against the wire models, host
                     syncs on the card, the ring's in-place accumulator.

CLI: ``python -m repro_torch.analysis [--ci] [--device D] [--json F]
[--sarif F] [--baseline F]``: lint only by default; ``--ci`` adds the
audits and exits 1 on any active finding.
"""
from repro_torch.analysis.findings import (Finding, active, apply_baseline,
                                           load_baseline, to_json, to_sarif)

__all__ = ["Finding", "active", "apply_baseline", "load_baseline",
           "to_json", "to_sarif"]
