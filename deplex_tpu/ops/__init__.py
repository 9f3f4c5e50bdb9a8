"""Device-side building blocks of the extraction pipeline.

Each module is the batched equivalent of one reference native component:

    eigh3x3    -- batched closed-form 3x3 eigensolve   (libs/dsyev)
    cellstats  -- cell validity gates + PCA plane fits  (cell_grid/cell_segment)
    histogram  -- spherical normals histogram           (normals_histogram)
    growing    -- region growing as label propagation   (plane_extractor growSeed)
    merge      -- plane-segment merging                 (findMergedLabels)
    ransac     -- batched plane RANSAC refinement       (libs/rtl)
"""
