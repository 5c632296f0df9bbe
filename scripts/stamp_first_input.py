#!/usr/bin/env python3
"""Stamp a served stage's fresh input apart, in a checkout whose realtime
backend still makes a first stage's input inside the enqueue.

    git archive <commit> | tar -x -C build/old
    python3 scripts/stamp_first_input.py build/old
    cp chip_smoke.py build/old/ && cd build/old
    python3 chip_smoke.py --serve resnet18 --repeats 3

Rewrites ``src/repro_torch/runtime/backend.py`` of the checkout at the
given path (one unpacked with ``git archive`` of a commit whose default
input factory calls ``torch.zeros`` for each job): the enqueue's
``input`` step becomes ``stream`` (the lane's stream made current),
``empty`` (``torch.empty`` of the input's shape), ``fill`` (its
``zero_``) and ``input`` (the rest: the job's state looked up, the
stream's event pair taken), so that the ``serving`` line's ``enqueue``
gives each apart (``step_median_by_stage``). A later stage, whose input
is its job's state, shows ``stream`` and ``input`` only. Exits non-zero,
changing nothing, where the checkout's code is not the form it expects.
"""
import sys
from pathlib import Path

ENQUEUE = '''            with seam.use(stream):
                rec.inp = x = self._stage_input(rec.inst, rec.lane)
                rec.start, rec.end = (ring.pop() if ring
                                      else (self._event(), self._event()))
                step("input")'''
STAMPED = '''            with seam.use(stream):
                step("stream")
                job = rec.inst.job
                if (self._job_state.get(job.job_id) is None
                        and getattr(self.input_factory, "_zeros_shape",
                                    None) is not None):
                    shape = self.input_factory._zeros_shape(job)
                    x = torch.empty(shape, dtype=torch.float32,
                                    device=self.device)
                    step("empty")
                    x.zero_()
                    step("fill")
                    rec.inp = x
                else:
                    rec.inp = x = self._stage_input(rec.inst, rec.lane)
                rec.start, rec.end = (ring.pop() if ring
                                      else (self._event(), self._event()))
                step("input")'''
FACTORY = '''    def make(job: Job):
        return torch.zeros((batch * job.n_inputs, input_hw, input_hw, 3),
                           dtype=torch.float32, device=device)
    return make'''
SHAPED = '''    def make(job: Job):
        return torch.zeros((batch * job.n_inputs, input_hw, input_hw, 3),
                           dtype=torch.float32, device=device)
    make._zeros_shape = lambda job: (batch * job.n_inputs, input_hw,
                                     input_hw, 3)
    return make'''


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    path = Path(sys.argv[1]) / "src/repro_torch/runtime/backend.py"
    src = path.read_text()
    if src.count(ENQUEUE) != 1 or src.count(FACTORY) != 1:
        print(f"{path}: not the enqueue and input factory this script "
              f"stamps", file=sys.stderr)
        return 1
    path.write_text(src.replace(ENQUEUE, STAMPED).replace(FACTORY, SHAPED))
    return 0


if __name__ == "__main__":
    sys.exit(main())
