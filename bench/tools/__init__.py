"""Tools of the benchmark that its runs do not call: the control and fault
readings, and the toy checkout for CPU runs."""
