"""The frame benchmark's harness: the cell's spec, inputs, the timed
window, the traced slice and the comparison with the frozen reference."""
