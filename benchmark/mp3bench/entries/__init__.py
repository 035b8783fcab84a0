"""One module per entry of the program that a traffic mix can drive, named
by the mix's "entry". Each defines:

- prepare(cell, seed) -> Work: the inputs of every distinct batch, made
  from the seed at set-up and held in memory (.batches, each with
  .inputs, the list handed to the program);
- call(m, batch, device): one call of the entry on a batch (m is the
  imported program), returning its outputs, aligned with the inputs;
- completed(outputs, batch) -> (audio seconds, streams failed): what the
  call returned whole;
- keep(outputs, batch, k): the part of stream k's output that the check
  needs, small enough to hold over the window;
- check(kept, work, cell) -> {number: value}: the kept outputs against
  the plain reference, each kept item as (batch index, k, keep());
- control(kept, work, cell, m, device) -> kept: what the control gives in
  the program's place (calibrate.py; the benchmark's runs never call it).
"""
