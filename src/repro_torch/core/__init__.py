"""FaTRQ core math: packing, ternary codes, decomposition, calibration,
the progressive estimator and the TRQ encoder."""
