"""Analysis workflows of the port: the reference notebooks as library
functions, and the class names that evaluation prints.

  tsne     Plot_Tsne_Notebook.ipynb: latent-space t-SNE of encoder /
           penultimate features (`analysis.tsne`).
  predict  the notebooks' "save output coloured maps for analysis":
           colorized prediction PNGs (`analysis.predict`).

The submodules are imported where they are used; sklearn, matplotlib and
PIL only when their functions run.
"""
