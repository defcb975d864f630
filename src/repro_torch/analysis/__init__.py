"""Cost model, roofline, collective traffic and report of the port
(counterpart of ``repro.analysis``): analytic FLOPs and bytes a cell
(``flops``), the H100 roofline (``roofline``), link bytes of the recorded
collectives (``collectives``, the counterpart of ``repro.analysis.hlo``)
and the markdown tables over a results directory (``report``)."""
